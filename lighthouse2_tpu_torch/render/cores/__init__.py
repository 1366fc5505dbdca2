from lighthouse2_tpu_torch.render.cores.base import (  # noqa: F401
    RenderCore, create_core)
