from jspsr_torch.nn.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    bicubic_resize,
    bilinear_resize,
    global_avg_pool,
    global_max_pool,
    init_weights,
)

__all__ = ["BatchNorm2d", "Conv2d", "ConvTranspose2d", "bicubic_resize",
           "bilinear_resize", "global_avg_pool", "global_max_pool",
           "init_weights"]
