"""The port's own spans and counters (``mpa_tpu_torch/utils/profiling.py``),
on the CPU at tiny sizes.

Off, the default, nothing is kept and a part-seg train step and serve call
give bit-equal answers to the same calls with spans on. On, a step and a
call of ``markov_partseg`` and ``dgcnn`` record the span names of each
layer, nested as ``PERF.md`` lists them, each unit's spans sharing its
identifier; the input pipeline's producer spans run on its thread; the
serve entry counts its host reads; each span's ``record_function`` event
in a profile lies where the span does on the same clock; and an exported
program holds no profiler op. A ``markov_semseg`` forward opens each block's
span once, and in ``window_all`` the Morton sort's and unsort's; its
neighbour searches count as windowed there and as exact in ``exact`` mode,
and ``windowed_search_share.train`` reads the share from the counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from mpa_tpu_torch.cli.train import augment_batch
from mpa_tpu_torch.configs import PRESETS
from mpa_tpu_torch.data.pipeline import prefetch_to_device
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.ops.window import check_in_window, make_window_spec
from mpa_tpu_torch.serve import Classifier, Segmenter
from mpa_tpu_torch.serve.export import export_inference
from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state
from mpa_tpu_torch.utils import profiling

# The suite's workers share the cores: one torch thread a process.
torch.set_num_threads(1)

CPU = torch.device("cpu")
LADDER = (32, 16, 8, 4)
PARTSEG_BLOCKS = ({"block.la0", "block.mlp", "block.head"}
                  | {f"block.{b}{i}" for b in ("la", "fps", "up_conv") for i in range(1, 5)}
                  | {f"block.la{i}_up" for i in range(1, 5)}
                  | {f"block.fuse{i}" for i in range(1, 6)})
DGCNN_BLOCKS = {"block.edge1", "block.edge2", "block.edge3", "block.edge4", "block.head"}
SEMSEG_BLOCKS = ({"block.la0", "block.mlp", "block.fuse_top", "block.head"}
                 | {f"block.{b}{i}" for b in ("la", "fps", "up_conv", "fuse") for i in range(1, 5)}
                 | {f"block.la{i}_up" for i in range(1, 5)})
# A semseg forward's neighbour searches: la0's self-kNN; la1-la4 a spatial and a
# feature-space one each; la2_up-la4_up the same, la1_up its feature-space one
# (scale 0's spatial index is la0's); the fuses toward scales 2, 1 and 0 one
# fresh search for each coarser scale two or more away.
SEMSEG_SEARCHES = 1 + 2 * 4 + (1 + 2 * 3) + (1 + 2 + 3)


@pytest.fixture
def recording():
    """Spans on, counters from zero; spans off again after the test."""
    profiling.reset_counts()
    profiling.spans = []
    try:
        yield profiling.spans
    finally:
        profiling.spans = None


def _clouds(b=2, n=64, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _model(name):
    torch.manual_seed(0)
    if name == "markov_partseg":
        return get_model(name, npoints=LADDER)
    return get_model(name, num_classes=5, k=4)


def _trainer(name):
    """A tiny model's train state and step, and one batch ``(inputs, labels)``
    as the step takes it."""
    partseg = name == "markov_partseg"
    cfg = PRESETS["shapenetpart" if partseg else "scanobjectnn_cls"].with_overrides(
        model=name, batch_size=2, num_points=64, seed=3)
    state = create_train_state(_model(name), cfg, CPU)
    step = TRAIN_STEPS[cfg.task](cfg, 4)
    pts = torch.from_numpy(_clouds())
    if partseg:
        onehot = torch.nn.functional.one_hot(torch.tensor([0, 3]), 16).float()
        return cfg, state, step, (pts, onehot), torch.randint(0, 50, (2, 64))
    return cfg, state, step, pts, torch.tensor([1, 4])


def _train(cfg, state, step, inputs, labels):
    """``cli.train``'s step: the augmentation, then the train step."""
    raw = inputs[0] if isinstance(inputs, tuple) else inputs
    points = augment_batch(cfg, raw, state.step)
    return step(state, (points, inputs[1]) if isinstance(inputs, tuple) else points, labels)


def _serve(name):
    model = _model(name).eval()
    if name == "markov_partseg":
        seg = Segmenter(model, CPU)
        return lambda: seg(_clouds(), np.array([0, 3]))
    cls = Classifier(model, CPU)
    return lambda: cls(_clouds())


def test_spans_off_keep_nothing_and_change_no_answer():
    assert profiling.spans is None
    assert profiling.span("serve.request") is profiling.span("block.la0")  # one shared no-op
    answers = []
    for on in (False, True):
        profiling.spans = [] if on else None
        try:
            cfg, state, step, inputs, labels = _trainer("markov_partseg")
            loss = _train(cfg, state, step, inputs, labels)
            answers.append((loss, [p.detach().clone() for p in state.model.parameters()],
                            _serve("markov_partseg")()))
            assert bool(profiling.spans) == on
        finally:
            profiling.spans = None
    (loss0, params0, out0), (loss1, params1, out1) = answers
    assert torch.equal(loss0, loss1) and torch.equal(out0, out1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))


@pytest.mark.parametrize("name", ["markov_partseg", "dgcnn"])
def test_spans_nest_by_layer_with_one_unit_each(name, recording):
    cfg, state, step, inputs, labels = _trainer(name)
    for _ in range(2):
        _train(cfg, state, step, inputs, labels)
    trained = list(recording)
    recording.clear()
    call = _serve(name)
    call()
    call()
    served = list(recording)
    blocks = PARTSEG_BLOCKS if name == "markov_partseg" else DGCNN_BLOCKS

    parent = {"train.augment": None, "train.step": None, "train.forward": "train.step",
              "train.loss": "train.step", "train.backward": "train.step",
              "train.optimizer": "train.step", **{b: "train.forward" for b in blocks}}
    if name == "dgcnn":  # the cls preset draws no augmentation
        del parent["train.augment"]
    assert {s[0] for s in trained} == set(parent)
    for s in trained:
        assert s[1] == parent[s[0]] and s[3] == threading.current_thread().name
        assert s[4] <= s[5]
    assert sorted({s[2] for s in trained}) == [0, 1]  # the step count
    for unit in (0, 1):
        assert sorted(s[0] for s in trained if s[2] == unit) == sorted(parent)

    parent = {"serve.request": None, "serve.inputs": "serve.request",
              "serve.forward": "serve.request", **{b: "serve.forward" for b in blocks}}
    assert {s[0] for s in served} == set(parent)
    assert all(s[1] == parent[s[0]] for s in served)
    units = sorted({s[2] for s in served})
    assert len(units) == 2 and units == [profiling.COUNTS["serve_calls"] - 1,
                                         profiling.COUNTS["serve_calls"]]
    for unit in units:
        assert sorted(s[0] for s in served if s[2] == unit) == sorted(parent)
        root = next(s for s in served if s[2] == unit and s[0] == "serve.request")
        assert all(root[4] <= s[4] <= s[5] <= root[5] for s in served if s[2] == unit)


def test_prefetch_spans_run_on_its_thread_and_count_empty_waits(recording):
    def slow(batch):
        time.sleep(0.02)  # so the consumer finds the queue empty
        return batch

    batches = [np.full((2, 3), i, np.float32) for i in range(4)]
    got = list(prefetch_to_device(iter(batches), CPU, transform=slow))
    assert [int(b[0, 0]) for b in got] == [0, 1, 2, 3]
    by = {}
    for name, parent, unit, thread, start, end in recording:
        by.setdefault(name, []).append((unit, thread))
        assert parent is None and start <= end
    for name in ("pipeline.transform", "pipeline.pin"):
        assert by[name] == [(i, "prefetch_to_device") for i in range(4)]
    main = threading.current_thread().name
    assert by["pipeline.copy"] == [(i, main) for i in range(4)]
    assert by["pipeline.wait"] == [(i, main) for i in range(5)]  # the fifth takes the end
    assert profiling.COUNTS["input_waits"] == 5
    assert 1 <= profiling.COUNTS["input_empty"] <= 5


def test_host_syncs_count_the_segmenters_category_reads(recording):
    call = _serve("markov_partseg")
    call()
    call()
    counts = dict(profiling.COUNTS)
    assert counts["host_syncs.serve.category_read"] == 4  # the min and the max, a call
    assert counts["host_syncs.serve.input_copy"] == 0  # no copy to a card here
    assert profiling.host_syncs(counts) == 4 and counts["serve_calls"] == 2
    check_in_window(torch.zeros((1, 16, 2), dtype=torch.long), make_window_spec(16, 32), "idx")
    assert profiling.COUNTS["host_syncs.window.check"] == 1


def test_spans_and_the_profilers_events_share_a_clock(recording):
    call = _serve("dgcnn")
    call()
    recording.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith(("serve.", "block.")):
            events[e.name] = (origin + e.time_range.start * 1e3, origin + e.time_range.end * 1e3)
    assert set(events) == {s[0] for s in recording}
    for name, _, _, _, start, end in recording:
        a, b = events[name]
        assert abs(a - start) < 1e6 and abs(b - end) < 1e6, name


def test_exported_program_holds_no_profiler_op(recording):
    """With spans on, so that :func:`profiling.span` meets the export's trace
    (off, it is ``nullcontext``, which no trace sees)."""
    ep = export_inference(_model("dgcnn"), torch.from_numpy(_clouds(1, 32)), device="cpu")
    assert recording == []
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


@pytest.mark.parametrize("mode", ["window_all", "exact"])
def test_semseg_spans_and_neighbour_search_counts(mode, recording):
    """At 2 x 2048 points (ladder 1024/512/256/128) every scale pair admits
    a window, so ``window_all`` searches nothing exactly."""
    torch.manual_seed(0)
    model = get_model("markov_semseg", npoints=(1024, 512, 256, 128), neighbor_mode=mode).eval()
    points = np.random.default_rng(1).standard_normal((2, 2048, 9)).astype(np.float32)
    with torch.no_grad():
        model(torch.from_numpy(points))
    morton = {"window.morton_sort", "window.morton_unsort"} if mode == "window_all" else set()
    assert sorted(s[0] for s in recording) == sorted(SEMSEG_BLOCKS | morton)  # each once
    assert all(s[1] is None for s in recording)  # no entry span around a bare forward
    windowed = SEMSEG_SEARCHES if mode == "window_all" else 0
    assert profiling.COUNTS["knn.windowed"] == windowed
    assert profiling.COUNTS["knn.exact"] == SEMSEG_SEARCHES - windowed


def test_windowed_search_share_reads_the_counters():
    from portbench.spec import PKG, load_module

    read = load_module(PKG / "metrics" / "windowed_search_share.train.py",
                       "portbench.metrics.windowed_search_share.train").read
    assert read({}, {"knn.windowed": 3, "knn.exact": 1}) == 75.0
    assert read({}, {"knn.windowed": SEMSEG_SEARCHES, "knn.exact": 0}) == 100.0
    assert read({}, {"knn.windowed": 0, "knn.exact": 0}) is None
    assert read({}, {"serve_calls": 2}) is None  # a program without the counters
    profiling.reset_counts()
    profiling.COUNTS["knn.exact"] = 4
    assert read({}) == 0.0  # the program's own counters
    profiling.reset_counts()
