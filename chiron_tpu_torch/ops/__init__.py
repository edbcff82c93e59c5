"""Kernel wrappers, decoders and the native host library's build.

The experimental decoders are exported here, as ``chiron_tpu/ops/__init__.py``
exports them, but loaded on first use: the host-only modules that import
``ops.host_build`` (the ``.signal`` parser, the assembler) stay free of torch.
"""

_CTC_MC = ("best_path_decode", "mc_decode", "section_decoding")


def __getattr__(name):
    if name in _CTC_MC:
        from chiron_tpu_torch.ops import ctc_mc

        return getattr(ctc_mc, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
