from repro_torch.kernels.veds_score.ops import (  # noqa: F401
    veds_dt_score, veds_dt_score_plain)
