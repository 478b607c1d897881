"""The port's overlap primitives against the JAX package's
(``cron_operator_tpu/parallel/overlap.py``, ``workloads/data.py``):
``chunk_schedule`` on a table of cases, ``DoubleBuffer``'s error, end and
close semantics, ``grouped`` on a partial group, and the launch accounting
of captured kernels (:func:`ops.flash_attention.capture_launches`).
``StepGraph`` itself needs a card (``tests/test_torch_graphs_cuda.py``)."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib
import threading
import time

import pytest

from cron_operator_tpu.parallel.overlap import chunk_schedule as jax_chunk_schedule
from cron_operator_tpu.workloads.data import grouped as jax_grouped
from cron_operator_tpu_torch.parallel.overlap import DoubleBuffer, chunk_schedule
from cron_operator_tpu_torch.workloads.data import ChunkStager, grouped

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

SCHEDULES = [
    # (start, target, steps_per_call, boundary)
    (0, 10, 1, 0),  # one step per call
    (0, 16, 8, 0),  # whole calls
    (0, 10, 8, 0),  # a tail of 2
    (3, 10, 4, 0),  # resumed mid-run
    (0, 3, 8, 0),  # fewer steps than a call
    (0, 25, 8, 10),  # snapped to save_every multiples
    (7, 30, 4, 5),  # resumed, snapped
    (10, 10, 8, 0),  # nothing to do
    (12, 10, 8, 0),  # past the target
    (0, 7, 0, 0),  # steps_per_call below 1 counts as 1
]


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_chunk_schedule_matches_jax(case):
    got = chunk_schedule(*case)
    assert got == jax_chunk_schedule(*case)
    start, target = case[0], case[1]
    assert sum(got) == max(0, target - max(0, start))


def test_double_buffer_stages_in_order():
    buf = DoubleBuffer(range(5), lambda x: x * 10, depth=2)
    assert list(buf) == [0, 10, 20, 30, 40]
    buf.close()


def test_double_buffer_reraises_on_the_consumer_then_ends():
    def items():
        yield 1
        raise RuntimeError("stage failed")

    buf = DoubleBuffer(items(), lambda x: x)
    assert next(buf) == 1
    with pytest.raises(RuntimeError, match="stage failed"):
        next(buf)
    # terminal: never parks on the dead producer
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(buf)
    buf.close()


def test_double_buffer_close_unparks_the_producer():
    """A producer parked on a full queue (an infinite stream, depth 1) ends
    on close(), and next() keeps raising StopIteration after it."""
    def forever():
        i = 0
        while True:
            yield i
            i += 1

    buf = DoubleBuffer(forever(), lambda x: x, depth=1, name="test-close")
    assert next(buf) == 0
    time.sleep(0.2)  # let the producer fill the queue and park
    buf.close()
    assert not buf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(buf)
    assert not any(t.name == "test-close" for t in threading.enumerate())


@pytest.mark.parametrize("n, schedule", [(7, [3, 3, 3]), (6, [4, 4]),
                                         (2, [5]), (0, [2])])
def test_grouped_yields_the_partial_group(n, schedule):
    got = list(grouped(iter(range(n)), schedule))
    assert got == list(jax_grouped(iter(range(n)), schedule))
    assert sum(got, []) == list(range(n))


def test_chunk_stager_places_each_group():
    stager = ChunkStager(iter(range(10)), [4, 4, 2], lambda g: tuple(g))
    assert list(stager) == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9)]
    stager.close()


CAPTURED, OTHER = 0x1000, 0x2000  # two stream handles


def test_captured_launches_count_once_per_replay():
    """A capture records the launches on its stream apart (the wrappers'
    counts stay), from any thread (the autograd engine launches a captured
    backward from its own), and each replay adds them, per design."""
    fn = fa.flash_attention_dq
    before = fn.launches, dict(fn.launches_by_design)
    with fa.capture_launches(CAPTURED) as tally:
        fa._count(fn, "sm90", CAPTURED)
        t = threading.Thread(target=fa._count, args=(fn, "sm90", CAPTURED))
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    assert tally == {(fn, "sm90"): 2}
    assert (fn.launches, fn.launches_by_design) == before
    fa.count_replays(tally, 3)
    assert fn.launches == before[0] + 6
    assert fn.launches_by_design["sm90"] == before[1]["sm90"] + 6
    fa._count(fn, "fma", CAPTURED)  # after the capture: counted at once
    assert fn.launches == before[0] + 7


def test_launches_on_other_streams_count_during_a_capture():
    """Another stream's launches (another job's, a staging thread's) during
    a capture are launches."""
    fn = fa.flash_attention
    before = fn.launches
    with fa.capture_launches(CAPTURED) as tally:
        fa._count(fn, "fma", OTHER)
    assert tally == {}
    assert fn.launches == before + 1


def test_step_graph_holds_a_bound_step_weakly():
    """A trainer holds its StepGraph and the graph its step (``Trainer.
    _update``): a bound method is held weakly, so the pair goes with the
    owner's last reference (no cycle left for the collector; the graph's
    pool goes with it). A plain function is held as it is."""
    import gc
    import weakref

    from cron_operator_tpu_torch.parallel.overlap import StepGraph

    class Owner:
        def step(self, inputs):
            return inputs

    owner = Owner()
    owner.graph = StepGraph(owner.step)
    assert owner.graph._fn()({"x": 1}) == {"x": 1}
    gone = weakref.ref(owner)
    gc.disable()
    try:
        del owner
        assert gone() is None
    finally:
        gc.enable()

    def step(inputs):
        return inputs

    assert StepGraph(step)._fn() is step
