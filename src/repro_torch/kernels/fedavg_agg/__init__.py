from repro_torch.kernels.fedavg_agg.ops import (  # noqa: F401
    fedavg_agg, fedavg_agg_plain, fedavg_agg_tree)
