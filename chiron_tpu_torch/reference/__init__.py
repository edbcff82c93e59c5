"""Plain references the port's tests hold it to, written without the port's
modules or kernels (``bonito_crf``: Bonito's CTC-CRF basecaller)."""
