"""The merge layer: host seconds of the last automatic-mask call's class
merge and one-hot masks (`semantic_merge.merge_classes`,
`masks_from_labels`: the merged labels to the card and the masks made
there, where `stylize` calls it), from the program's counter
`segmentation.last_call`; None where the program keeps no such record."""


def read(r):
    from dpst_tpu_torch import segmentation
    rec = getattr(segmentation, "last_call", None)
    return None if rec is None else rec.merge_s
