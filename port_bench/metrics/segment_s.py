"""The segmentation layer: host seconds of the last automatic-mask call's
PSPNet stage (both photos squashed, their forwards, the scores back to full
size, the arg-max, the label maps on the host), from the program's counter
`segmentation.last_call`; None where the program keeps no such record."""


def read(r):
    from dpst_tpu_torch import segmentation
    rec = getattr(segmentation, "last_call", None)
    return None if rec is None else rec.segment_s
