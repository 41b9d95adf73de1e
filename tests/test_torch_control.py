"""The port's control guardrails and ingest autotuner against the JAX
package's, on the CPU.

The same seeded ``Signal`` sequences (and synthetic proposals for the
bare ``Guardrails``) drive both packages over equal synthetic knobs: the
decision journals are equal record for record, the knobs end equal, and
a shared ``TuningBudget`` denies and refunds alike
(``tests/test_ingest_pipeline.py``'s scenarios).  A hypothesis property
over both packages: the applied changes never exceed
``Guardrails.change_bound`` whatever the signal.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import sntc_tpu.data.autotune as JA
import sntc_tpu.data.pipeline as JP
import sntc_tpu.resilience.control as JC
import sntc_tpu_torch.data.autotune as PA
import sntc_tpu_torch.data.pipeline as PP
import sntc_tpu_torch.resilience.control as PC
from jax_metrics_guard import own_jax_registry  # noqa: F401

PACKAGES = {"jax": (JA, JP, JC), "port": (PA, PP, PC)}
KNOB_SPEC = {"read_workers": (1, 1, 4), "prefetch_batches": (2, 1, 8),
             "pipeline_depth": (2, 1, 4)}


def _knobs(pipeline, spec=KNOB_SPEC):
    """name -> (initial, lo, hi) as live Knobs over dicts."""
    knobs = {}
    for name, (val, lo, hi) in spec.items():
        box = {"v": val}
        knobs[name] = pipeline.Knob(
            name, (lambda b=box: b["v"]),
            (lambda n, b=box: b.__setitem__("v", int(n))), lo, hi)
    return knobs


def _signals(autotune, seed, n):
    """A seeded sequence of signals: starved, parse-bound, saturated and
    idle windows in random runs, with jittered fields."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        kind = int(rng.integers(4))
        for _ in range(int(rng.integers(1, 7))):
            j = float(rng.uniform(0.9, 1.1))
            if kind == 0:
                sig = dict(backlog=6, miss_rate=0.9 * j, queue_occupancy=0.3,
                           read_wait_s=0.4 * j, parse_s=0.01,
                           files_per_batch=1)
            elif kind == 1:
                sig = dict(backlog=6, miss_rate=0.3 * j, queue_occupancy=0.3,
                           read_wait_s=0.5, parse_s=0.45 * j,
                           files_per_batch=4)
            elif kind == 2:
                sig = dict(backlog=9, miss_rate=0.1, queue_occupancy=1.0,
                           read_wait_s=0.05 * j, parse_s=0.01,
                           files_per_batch=2)
            else:
                sig = dict(backlog=0, miss_rate=0.0, queue_occupancy=0.0,
                           read_wait_s=0.001, parse_s=0.001,
                           files_per_batch=1)
            out.append(autotune.Signal(**sig))
    return out[:n]


def _tuner_run(pkg, seed, windows, policy_kw, budget_caps=None):
    autotune, pipeline, control = PACKAGES[pkg]
    budget = (control.TuningBudget(**budget_caps)
              if budget_caps is not None else None)
    tuner = autotune.IngestAutotuner(
        policy=autotune.AutotunePolicy(**policy_kw), budget=budget)
    knobs = _knobs(pipeline)
    for sig in _signals(autotune, seed, windows):
        tuner.observe(sig, knobs)
    return (tuner.decisions, {k: v.get() for k, v in knobs.items()},
            sorted(tuner.frozen),
            budget.snapshot() if budget is not None else None)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy_kw", [
    {}, {"confirm": 1, "cooldown": 0},
    {"confirm": 2, "cooldown": 1, "max_reversals": 1},
])
def test_autotuner_journals_equal_across_packages(seed, policy_kw):
    jax = _tuner_run("jax", seed, 200, policy_kw)
    port = _tuner_run("port", seed, 200, policy_kw)
    assert port == jax
    assert jax[0]  # the sequence moved something


@pytest.mark.parametrize("seed", range(3))
def test_autotuner_budget_equal_across_packages(seed):
    caps = {"prefetch_batches": 2, "read_workers": 1}
    kw = {"confirm": 1, "cooldown": 0, "max_reversals": 5}
    jax = _tuner_run("jax", seed, 150, kw, caps)
    port = _tuner_run("port", seed, 150, kw, caps)
    assert port == jax
    assert any(d["action"] == "budget_denied" for d in jax[0])


def _guard_run(pkg, seed, windows):
    """Bare guardrails over random proposals, a budget on one knob."""
    _autotune, pipeline, control = PACKAGES[pkg]
    knobs = _knobs(pipeline)
    budget = control.TuningBudget(read_workers=2)
    journal = []
    guard = control.Guardrails(
        control.ControlPolicy(confirm=2, cooldown=1, max_reversals=2),
        budget=budget, journal_keep=16, on_journal=journal.append)
    rng = np.random.default_rng(seed)
    names = sorted(knobs)
    applied = []
    for w in range(windows):
        r = int(rng.integers(len(names) * 2 + 1))
        prop = (None if r == len(names) * 2
                else (names[r % len(names)], 1 if r < len(names) else -1))
        # repeat each draw so confirm streaks can form
        for _ in range(int(rng.integers(1, 4))):
            guard.observe(lambda p=prop: p, knobs,
                          lambda w=w: {"window": w},
                          on_applied=lambda n, d, v: applied.append(
                              (n, d, v)))
    return (journal, guard.decisions, guard.decisions_total, applied,
            sorted(guard.frozen), budget.snapshot(),
            {k: v.get() for k, v in knobs.items()})


@pytest.mark.parametrize("seed", range(5))
def test_guardrails_journals_equal_across_packages(seed):
    jax = _guard_run("jax", seed, 300)
    port = _guard_run("port", seed, 300)
    assert port == jax
    assert len(jax[1]) <= 16 < jax[2]  # bounded journal, total kept


def test_budget_charges_only_above_cold_value_in_both():
    """``tests/test_ingest_pipeline.py::test_budget_charges_only_above_
    cold_default`` on both packages: the same decisions and budget."""
    runs = []
    for pkg in PACKAGES:
        autotune, pipeline, control = PACKAGES[pkg]
        budget = control.TuningBudget(prefetch_batches=1)
        tuner = autotune.IngestAutotuner(
            policy=autotune.AutotunePolicy(confirm=1, cooldown=0,
                                           max_reversals=50),
            budget=budget)
        knobs = _knobs(pipeline, {"prefetch_batches": (4, 1, 8)})
        idle = autotune.Signal()
        starved = autotune.Signal(backlog=6, miss_rate=0.9,
                                  queue_occupancy=0.3, read_wait_s=0.4,
                                  parse_s=0.01)
        for sig in [idle] * 8 + [starved] * 20:
            tuner.observe(sig, knobs)
        assert knobs["prefetch_batches"].get() == 5  # cold 4 + cap 1
        runs.append((tuner.decisions, budget.snapshot()))
    assert runs[0] == runs[1]


def test_default_bounds_and_policies_equal():
    assert PP.DEFAULT_BOUNDS == JP.DEFAULT_BOUNDS
    assert PP.KNOB_NAMES == JP.KNOB_NAMES and PP.STAGES == JP.STAGES
    assert vars(PA.AutotunePolicy()) == vars(JA.AutotunePolicy())
    assert vars(PC.ControlPolicy()) == vars(JC.ControlPolicy())


SIGNAL = st.builds(
    dict,
    backlog=st.integers(0, 12),
    miss_rate=st.floats(0.0, 1.0),
    queue_occupancy=st.floats(0.0, 1.0),
    read_wait_s=st.floats(0.0, 1.0),
    parse_s=st.floats(0.0, 1.0),
    files_per_batch=st.integers(1, 4),
)


@settings(max_examples=40, deadline=None)
@given(signals=st.lists(SIGNAL, min_size=1, max_size=120),
       confirm=st.integers(1, 3), cooldown=st.integers(0, 2),
       max_reversals=st.integers(0, 3))
def test_applied_changes_never_exceed_the_change_bound(
        signals, confirm, cooldown, max_reversals):
    """The no-oscillation bound, in both packages, over any signal
    sequence: the applied changes are at most ``change_bound`` and the
    two packages apply the same ones."""
    applied = {}
    for pkg in PACKAGES:
        autotune, pipeline, control = PACKAGES[pkg]
        policy = autotune.AutotunePolicy(confirm=confirm, cooldown=cooldown,
                                         max_reversals=max_reversals)
        tuner = autotune.IngestAutotuner(policy=policy)
        knobs = _knobs(pipeline)
        # cycle the drawn signals long enough for every freeze to land
        for i in range(400):
            tuner.observe(autotune.Signal(**signals[i % len(signals)]), knobs)
        applied[pkg] = tuner.applied()
        assert len(applied[pkg]) <= control.Guardrails.change_bound(
            knobs, max_reversals)
    assert applied["port"] == applied["jax"]
