from microimagelib_tpu_torch.models.deconvolution import decon_singleview, gen_otf, rl_decon_single

__all__ = [
    "decon_singleview",
    "gen_otf",
    "rl_decon_single",
]
