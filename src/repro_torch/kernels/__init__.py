"""The hand-written Hopper kernels (`dom_admit`, `dom_release`,
`flash_attention`, `ssd_scan`), their plain torch versions, the dispatch
(`ops`), the oracles (`ref`) and the ctypes build (`build`). Port of
`repro/kernels` (all but `inchash`)."""
