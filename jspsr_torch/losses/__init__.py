from jspsr_torch.losses.functions import (
    berhu_loss,
    charbonnier_loss,
    edge_loss,
    get_loss,
    l1_loss,
    l2_loss,
    ssim_loss,
    surface_normal_loss,
    tv_loss,
)
from jspsr_torch.losses.schemes import MultiLoss, SingleLoss, build_criterion

__all__ = [
    "l1_loss", "l2_loss", "edge_loss", "charbonnier_loss", "berhu_loss",
    "tv_loss", "ssim_loss", "surface_normal_loss", "get_loss",
    "SingleLoss", "MultiLoss", "build_criterion",
]
