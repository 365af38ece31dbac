"""The hand-written Hopper kernels (`dom_admit`, `dom_release`,
`flash_attention`), their plain torch versions, the dispatch (`ops`), the
attention oracle (`ref`) and the ctypes build (`build`). Port of
`repro/kernels` (all but `inchash` and `ssd_scan`)."""
