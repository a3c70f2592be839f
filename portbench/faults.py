"""Faults a served cell's timed path can have, each planted with a
``monkeypatch``-like ``mp`` (``mp.setattr(obj, name, value)``) before
the cell is set up, so that its captured graphs hold it too. The check
has to turn ``correct`` false under each: ``tests/test_portbench_faults.py``
on tiny cells on the CPU, ``control.py --fault`` at a cell's own size on
the card."""


def state_unchanged(mp):
    """A step that returns its state as it found it: no KV entry and no
    SSM state is written."""
    from repro_torch.models import blocks, transformer
    mp.setattr(blocks, "_scatter_kv", lambda *a, **k: None)
    mp.setattr(transformer, "_write_back", lambda writes: None)


def half_the_batch(mp):
    """Half of the slots' rows left out of every step (their cache rows
    and state not advanced), their tokens still served."""
    from repro_torch.serve.scheduler import Scheduler
    real = Scheduler.run_step

    def step(self, b, inputs, *, graph=None):
        inputs = inputs.clone()
        inputs[2, 1::2] = 0
        return real(self, b, inputs, graph=graph)
    mp.setattr(Scheduler, "run_step", step)


def no_exchange(mp):
    """The per-layer AllReduce between the TP ranks left out: each rank
    keeps its partial sum."""
    from repro_torch.distributed.step import TPDecodeComms
    mp.setattr(TPDecodeComms, "hidden", lambda self, x: x)


def token_altered(mp):
    """A served token altered where it is produced (the sampler)."""
    from repro_torch.serve.scheduler import Scheduler
    real = Scheduler._sample

    def sample(self, logits, rows):
        tok = real(self, logits, rows)
        return (tok + 1) % logits.shape[-1]
    mp.setattr(Scheduler, "_sample", sample)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch,
                                  no_exchange, token_altered)}
