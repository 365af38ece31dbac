"""The hand-written Hopper kernels (`dom_admit`, `dom_release`,
`flash_attention`, `ssd_scan`, `inchash`), their plain torch versions, the
plain-version backward they share under autograd (`grad`), the
dispatch (`ops`), the oracles (`ref`) and the ctypes build (`build`). Port
of `repro/kernels`."""
