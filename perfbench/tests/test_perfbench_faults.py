"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run
(``run.report``) on the CPU at a small size, with the program broken
where it produces its answers or its state; the run must still print its
line, with ``correct`` false. The exchange between chips does not exist
in these one-chip cells."""
import json
from types import SimpleNamespace

import pytest
import torch

from perfbench import run

SEED = 2 ** 31 + 99
ONESHOT = ["t1_n2048_m200k.oneshot", "t1_n2048_m10k.oneshot"]
SERVED = ["t1_n2048_m200k.serve", "t1_n2048_m10k.slide"]


def _report(cell, capsys):
    args = SimpleNamespace(seed=SEED, seconds=0.4, trace=0)
    assert run.report(cell, args, torch.device("cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


def _cell(small, workload):
    # every answer compared: a fault that alters one answer a microbatch
    # is then caught however the host's speed groups the requests
    return small(workload, rate_per_s=400, warm_queue=4, check_every=2,
                 check_requests=10 ** 6)


@pytest.mark.parametrize("workload", ONESHOT + SERVED)
def test_a_sound_run_is_correct(workload, small, capsys):
    line = _report(_cell(small, workload), capsys)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]


def _altered(fn):
    """The answer of ``fn`` altered where it is produced: one part in a
    thousand of its first column."""
    def broken(*args, **kwargs):
        x = fn(*args, **kwargs).clone()
        x[..., 0] = x[..., 0] * 1.001 if x.ndim == 2 else x[..., 0]
        return x * 1.001 if x.ndim == 1 else x
    return broken


@pytest.mark.parametrize("workload", ONESHOT)
def test_an_altered_solve_is_caught(workload, small, capsys, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "chol_solve_fused",
                        _altered(ops.chol_solve_fused))
    line = _report(_cell(small, workload), capsys)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("workload", SERVED)
def test_an_altered_answer_is_caught(workload, small, capsys, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "serve_solve", _altered(ops.serve_solve))
    line = _report(_cell(small, workload), capsys)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("workload", SERVED)
def test_half_of_a_microbatch_left_out_is_caught(workload, small, capsys,
                                                 monkeypatch):
    from repro_torch.kernels import ops
    solve = ops.serve_solve

    def half(S, L, V, lam, **kw):
        h = V.shape[1] // 2
        X = torch.zeros((V.shape[0], V.shape[1]), dtype=torch.float32,
                        device=V.device)
        if h:
            X[:, :h] = solve(S, L, V[:, :h], lam, **kw)
            X[:, h:] = X[:, :h].mean(dim=1, keepdim=True)
        return X
    monkeypatch.setattr(ops, "serve_solve", half)
    line = _report(_cell(small, workload), capsys)
    assert line["correct"] is False


def test_a_fold_that_returns_its_state_unchanged_is_caught(small, capsys,
                                                           monkeypatch):
    from repro_torch.serve import OnlineAdaptation
    monkeypatch.setattr(OnlineAdaptation, "fold",
                        lambda self, state, rows, **kw: state)
    line = _report(_cell(small, "t1_n2048_m10k.slide"), capsys)
    assert line["correct"] is False
    assert line["checks"]["window_diff"]["value"] > 0


def test_a_fold_that_leaves_the_factor_behind_is_caught(small, capsys,
                                                        monkeypatch):
    from repro_torch.serve import OnlineAdaptation
    fold = OnlineAdaptation.fold

    def stale(self, state, rows, **kw):
        return fold(self, state, rows, **kw)._replace(L=state.L)
    monkeypatch.setattr(OnlineAdaptation, "fold", stale)
    # no refresh inside the window: the factor the window ends with is
    # the one its folds left
    cell = _cell(small, "t1_n2048_m10k.slide")
    cell.traffic["adaptation"] = {"refresh_every": 10 ** 6}
    line = _report(cell, capsys)
    assert line["correct"] is False
