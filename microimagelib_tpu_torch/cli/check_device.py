"""checkDevice — CUDA device census CLI (the reference's
``checkGPUDevice``, reference:src/check_gpu.cpp:1-13)."""

from microimagelib_tpu_torch.utils.device import query_device


def main(argv=None):
    query_device(verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
