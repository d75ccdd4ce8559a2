"""PSPNet-50 on the card: the bound of the last automatic-mask call's
forwards (`work/pspnet.py`, each one image at the evaluation size, in the
compute dtype) over their device time, from the CUDA events of the
program's counter `segmentation.last_call`; None where the program keeps
no such record or timed no forward on a card."""
from port_bench.work.peaks import bound_s, itemsize
from port_bench.work.pspnet import forward_work


def read(r):
    from dpst_tpu_torch import segmentation
    rec = getattr(segmentation, "last_call", None)
    if rec is None or not rec.forward_ms:
        return None
    bound = bound_s(*forward_work(rec.eval_size, itemsize(r.dtype)), r.dtype)
    return 100.0 * rec.forwards * bound / (rec.forward_ms / 1e3)
