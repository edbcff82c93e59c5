from chiron_tpu_torch.assembly.consensus import (  # noqa: F401
    consensus_to_bases,
    get_assembler_kernel,
    glue_kernel,
    global_kernel,
    qs,
    simple_assembly,
    simple_assembly_qs,
    simple_kernel,
    stick_kernel,
)
