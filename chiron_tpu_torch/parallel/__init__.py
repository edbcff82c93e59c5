"""Data parallelism: devices, batch and file sharding, moments across ranks."""
