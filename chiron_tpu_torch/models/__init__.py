from chiron_tpu_torch.models.model import (  # noqa: F401
    apply_model,
    model_ratio,
    model_stride,
    output_len,
)
