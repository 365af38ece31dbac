"""The hand-written Hopper DOM kernels, their plain torch versions, and
the ctypes build (`build`). Port of `repro/kernels` (DOM half)."""
