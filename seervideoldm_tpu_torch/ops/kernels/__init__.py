"""The port's hand-written CUDA kernels (``csrc/``), one wrapper module per
source."""


def launch_counters() -> dict:
    """``{name: wrapper}`` of every kernel wrapper; each wrapper's
    ``launches`` counts the kernel launches it made."""
    from . import flash_attention as fa
    from . import geglu_ff as gg
    from . import softmax_calib as sc
    from . import swat_attention as sw

    return {"swat_attention_tables": sw.swat_attention_tables,
            "flash_attention": fa.flash_attention,
            "ln_geglu_ff": gg.ln_geglu_ff,
            "ln_geglu_ff_proj": gg.ln_geglu_ff_proj, "geglu_ff": gg.geglu_ff,
            "swat_attention_tables_bwd": sw.swat_attention_tables_bwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "swat_attention": sw.swat_attention,
            "swat_attention_bwd": sw.swat_attention_bwd,
            "softmax_calib": sc.softmax_calib}
