"""Serving: export a model as a versioned bundle, serve it over TCP, call it remotely.

A port of ``chiron_tpu/serve``: the bundle layout and the wire protocol are
the JAX package's own, so either package's client talks to either package's
server, and each serves the other's bundles.
"""
