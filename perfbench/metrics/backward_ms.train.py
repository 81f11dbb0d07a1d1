"""Device milliseconds per training step in the port's phase
``trainer.backward``: the gradients (``loss.backward()``), between the CUDA
events that ``BaseTrainer.train_step`` records at the phase's entry and exit
while the profiler runs; the mean over the traced steps (the last ``calls``
roots ``trainer.train_step`` the port recorded). None where the port records
no such span or no device time."""

PHASE = "trainer.backward"


def read(ctx):
    from torchebm_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    roots = [s for s in profiling.spans() if s.parent is None and s.name == "trainer.train_step"]
    roots = roots[-ctx["trace"]["calls"]:]
    ms = [c.device_ms for r in roots for c in r.children if c.name == PHASE]
    if not ms or len(ms) != len(roots) or None in ms:
        return None
    return sum(ms) / len(ms)
