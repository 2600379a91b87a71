from jspsr_torch.nn.layers import (
    bilinear_resize,
    global_avg_pool,
    global_max_pool,
    init_weights,
)

__all__ = ["bilinear_resize", "global_avg_pool", "global_max_pool",
           "init_weights"]
