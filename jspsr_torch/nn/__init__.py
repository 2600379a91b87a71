from jspsr_torch.nn.layers import global_avg_pool, global_max_pool, init_weights

__all__ = ["global_avg_pool", "global_max_pool", "init_weights"]
