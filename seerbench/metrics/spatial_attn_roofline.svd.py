"""spatial_attn_roofline.svd: the roofline bound of the program's ``site.attn.spatial_self`` spans (``roofline_svd.spatial_attention_bound`` of each span's shape) over their device ms (CUDA events), in %."""
from seerbench import program_spans
from seerbench.roofline_svd import spatial_attention_bound


def read(record):
    sites = [s for s in program_spans.spans("site.attn.spatial_self")
             if s["device_ms"]]
    if not sites:
        return None
    bound = sum(spatial_attention_bound(s["ids"]) for s in sites)
    return 100.0 * bound / (1e-3 * sum(s["device_ms"] for s in sites))
