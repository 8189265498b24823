from repro_torch.checkpoint.np_ckpt import (  # noqa: F401
    load_checkpoint, save_checkpoint)
