from repro_torch.optim.optimizers import (  # noqa: F401
    adam, momentum, sgd, cosine_schedule, linear_warmup,
)
