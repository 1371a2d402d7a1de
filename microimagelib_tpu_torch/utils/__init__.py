from microimagelib_tpu_torch.utils.device import query_device

__all__ = ["query_device"]
