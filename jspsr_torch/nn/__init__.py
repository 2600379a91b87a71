from jspsr_torch.nn.layers import (
    bicubic_resize,
    bilinear_resize,
    global_avg_pool,
    global_max_pool,
    init_weights,
)

__all__ = ["bicubic_resize", "bilinear_resize", "global_avg_pool",
           "global_max_pool", "init_weights"]
