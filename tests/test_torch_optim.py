"""The NGD optimizer of the torch port against the JAX package: per-sample
score blocks (values, block order and names), the matrix-free Fisher
matvec, one ``NaturalGradient`` step with the kernel-composed solver and
with ``"chol"`` (momentum and clip), the MLP trainer step of
``examples/ngd_mlp_train.py`` at a small width, the schedules, AdamW, and
the parameter-tree conversion both ways.

Inputs are one numpy draw handed to both packages. Tolerances: 1e-5
relative for scores and matvecs (fp32 gradients summed in other orders),
rtol 1e-3 / atol 1e-5 for updates — those of ``tests/test_optim.py``.
"""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.core import BlockedScores
from repro_torch.curvature import StreamingCurvature
from repro_torch.kernels import ops
from repro_torch.optim import (AdamW, NaturalGradient, constant, flatten_like,
                               global_norm, lazy_score_blocks,
                               make_fisher_matvec, params_from_arrays,
                               params_to_arrays, per_sample_score_blocks,
                               per_sample_scores, warmup_cosine, warmup_linear)

import jax
import jax.numpy as jnp
from repro import optim as joptim
from repro.kernels import ops as jops
from repro.optim.ngd import global_norm as j_global_norm

torch.set_num_threads(1)

SCORE_TOL = 1e-5


def _tree_rel(a: dict, b: dict) -> float:
    return max(rel(a[k], b[k]) for k in b)


# ---------------------------------------------------------------------------
# problems, defined for both packages from one numpy draw
# ---------------------------------------------------------------------------

def logreg_problem(n=64, d=10, c=4, seed=0):
    """``tests/test_optim.py``'s logistic regression on both sides."""
    rng = np.random.default_rng(seed)
    arrays = {"w": (rng.normal(size=(d, c)) * 0.1).astype(np.float32),
              "b": np.zeros((c,), np.float32)}
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.integers(0, c, size=(n,))

    def jlogp(p, ex):
        x, y = ex
        return jax.nn.log_softmax(x @ p["w"] + p["b"])[y]

    def tlogp(p, ex):
        x, y = ex
        return torch.gather(torch.log_softmax(x @ p["w"] + p["b"], -1), 0,
                            y[None])[0]

    def jloss(p):
        return -jnp.mean(jax.vmap(lambda ex: jlogp(p, ex))((jnp.asarray(X),
                                                            jnp.asarray(Y))))

    def tloss(p):
        return -torch.func.vmap(lambda ex: tlogp(p, ex))(
            (torch.from_numpy(X), torch.from_numpy(Y))).mean()

    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    tp = params_from_arrays(arrays, device="cpu")
    return (jp, (jnp.asarray(X), jnp.asarray(Y)), jlogp, jloss,
            tp, (torch.from_numpy(X), torch.from_numpy(Y)), tlogp, tloss)


def mlp_problem(d_in=8, width=16, n=32, seed=0):
    """``examples/ngd_mlp_train.py``'s tanh MLP and its residual rows, both
    sides (the chip smoke test drives the same model at full width)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "w1": (rng.normal(size=(d_in, width)) / d_in ** 0.5).astype(np.float32),
        "b1": np.zeros((width,), np.float32),
        "w2": (rng.normal(size=(width, width)) / width ** 0.5).astype(np.float32),
        "b2": np.zeros((width,), np.float32),
        "w3": (rng.normal(size=(width, 1)) / width ** 0.5).astype(np.float32),
    }
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    y = (np.sin(3 * X[:, :1]).sum(-1) + 0.5 * np.cos(X[:, 1])).astype(np.float32)

    def predict(tanh, p, x):
        h = tanh(x @ p["w1"] + p["b1"])
        h = tanh(h @ p["w2"] + p["b2"])
        return (h @ p["w3"])[..., 0]

    def jobj(p, ex):
        return predict(jnp.tanh, p, ex[0][None])[0] - ex[1]

    def tobj(p, ex):
        return predict(torch.tanh, p, ex[0][None])[0] - ex[1]

    def jloss(p):
        return jnp.mean((predict(jnp.tanh, p, jnp.asarray(X)) - jnp.asarray(y)) ** 2)

    def tloss(p):
        return torch.mean((predict(torch.tanh, p, torch.from_numpy(X))
                           - torch.from_numpy(y)) ** 2)

    return (arrays, (X, y), jobj, jloss, tobj, tloss)


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"chunk": 16}, {"center": True},
                                {"scale": 0.25}],
                         ids=["plain", "chunk", "center", "scale"])
def test_score_blocks_match_jax(kw):
    jp, jb, jlogp, _, tp, tb, tlogp, _ = logreg_problem()
    B = per_sample_score_blocks(tlogp, tp, tb, **kw)
    Bj = joptim.per_sample_score_blocks(jlogp, jp, jb, **kw)
    assert B.names == Bj.names == ("['b']", "['w']")
    assert B.block_widths == Bj.block_widths == (4, 40)
    assert rel(B.to_dense(), Bj.to_dense()) < SCORE_TOL
    S = per_sample_scores(tlogp, tp, tb, **kw)
    assert S.shape == (64, 44)
    assert rel(S, joptim.per_sample_scores(jlogp, jp, jb, **kw)) < SCORE_TOL


def test_score_blocks_bf16_and_lazy():
    jp, jb, jlogp, _, tp, tb, tlogp, _ = logreg_problem(seed=1)
    B = per_sample_score_blocks(tlogp, tp, tb, dtype=torch.bfloat16)
    Bj = joptim.per_sample_score_blocks(jlogp, jp, jb, dtype=jnp.bfloat16)
    assert B.dtype == torch.bfloat16
    # one bf16 rounding apart at most
    assert rel(B.to_dense(), Bj.to_dense()) < 1e-2
    lazy = lazy_score_blocks(tlogp, tp, tb)
    assert lazy.shape == (64, 44)
    assert torch.equal(lazy.to_dense(), per_sample_scores(tlogp, tp, tb))


def test_mlp_block_order_follows_jax_flatten_order():
    """Parameters defined w1, b1, w2, b2, w3 flatten as b1, b2, w1, w2, w3
    (sorted keys), so blocks and gradient leaves line up with the JAX
    package's."""
    arrays, (X, y), jobj, _, tobj, _ = mlp_problem()
    tp = params_from_arrays(arrays, device="cpu")
    B = per_sample_score_blocks(tobj, tp, (X, y), device="cpu")
    Bj = joptim.per_sample_score_blocks(
        jobj, {k: jnp.asarray(v) for k, v in arrays.items()},
        (jnp.asarray(X), jnp.asarray(y)))
    assert B.names == Bj.names == ("['b1']", "['b2']", "['w1']", "['w2']",
                                   "['w3']")
    assert B.block_widths == Bj.block_widths == (16, 16, 128, 256, 16)
    assert rel(B.to_dense(), Bj.to_dense()) < SCORE_TOL
    flat, unravel = flatten_like(tp)
    assert flat.shape == (432,)
    back = unravel(flat)
    assert all(torch.equal(back[k], tp[k]) for k in tp)


def test_fisher_matvec_matches_jax_and_explicit():
    jp, jb, jlogp, _, tp, tb, tlogp, _ = logreg_problem()
    rng = np.random.default_rng(5)
    xj, xt = pair(rng.normal(size=(44,)))
    mv = make_fisher_matvec(tlogp, tp, tb, damping=0.05)
    mvj = joptim.make_fisher_matvec(jlogp, jp, jb, damping=0.05)
    assert rel(mv(xt), mvj(xj)) < SCORE_TOL
    S = per_sample_scores(tlogp, tp, tb)
    assert rel(mv(xt), S.T @ (S @ xt) + 0.05 * xt) < 1e-4


# ---------------------------------------------------------------------------
# NaturalGradient
# ---------------------------------------------------------------------------

def _fused(S, v, lam):
    return ops.chol_solve_fused(S, v, lam)


def _jfused(S, v, lam):
    return jops.chol_solve_fused(S, v, lam, mode="interpret")


@pytest.mark.parametrize("solver", ["chol", "fused"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_ngd_step_matches_jax(solver, blocked):
    """One step with momentum and clip, then a second (momentum carried)."""
    jp, jb, jlogp, jloss, tp, tb, tlogp, tloss = logreg_problem()
    kw = dict(damping=1e-2, momentum=0.9, clip_natgrad_norm=0.1)
    opt = NaturalGradient(0.5, solver=_fused if solver == "fused" else "chol",
                          **kw)
    jopt = joptim.NaturalGradient(
        0.5, solver=_jfused if solver == "fused" else "chol", **kw)
    st, jst = opt.init(tp), jopt.init(jp)
    for _ in range(2):
        if blocked:
            S = per_sample_score_blocks(tlogp, tp, tb)
            Sj = joptim.per_sample_score_blocks(jlogp, jp, jb)
        else:
            S = per_sample_scores(tlogp, tp, tb)
            Sj = joptim.per_sample_scores(jlogp, jp, jb)
        g = torch.func.grad(tloss)(tp)
        gj = jax.grad(jloss)(jp)
        upd, st = opt.update(g, st, tp, scores=S)
        jupd, jst = jopt.update(gj, jst, jp, scores=Sj)
        for k in ("w", "b"):
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-3, atol=1e-5)
        tp = {k: tp[k] + upd[k] for k in tp}
        jp = {k: jp[k] + jupd[k] for k in jp}
    assert st.step == 2 and int(jst.step) == 2
    assert sorted(st.momentum) == ["b", "w"]
    assert float(global_norm(st.momentum)) <= 0.1 * 1.9 + 1e-5
    assert abs(float(global_norm(st.momentum))
               - float(j_global_norm(jst.momentum))) < 1e-5


def test_mlp_trainer_step_matches_jax():
    """The chip smoke test's trainer path at a small width: residual rows as
    blocked scores, ∇(½ MSE) as v, the kernel-composed solver, 3 steps.
    Each JAX step starts from the port's parameters, and λ = 1e-2: this
    432-parameter model interpolates its 32 samples after one step at the
    example's λ = 1e-3, and then x = (v − Sᵀw)/λ cancels to fp32 rounding
    in both packages (each 1e-3 from a float64 solve)."""
    arrays, (X, y), jobj, jloss, tobj, tloss = mlp_problem()
    tp = params_from_arrays(arrays, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    opt = NaturalGradient(1.0, damping=1e-2, momentum=0.0, solver=_fused)
    jopt = joptim.NaturalGradient(1.0, damping=1e-2, momentum=0.0)
    st, jst = opt.init(tp), jopt.init(jp)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for _ in range(3):
        S = per_sample_score_blocks(tobj, tp, (Xt, yt))
        Sj = joptim.per_sample_score_blocks(
            jobj, jp, (jnp.asarray(X), jnp.asarray(y)))
        g = torch.func.grad(lambda q: 0.5 * tloss(q))(tp)
        gj = jax.grad(lambda q: 0.5 * jloss(q))(jp)
        upd, st = opt.update(g, st, tp, scores=S)
        jupd, jst = jopt.update(gj, jst, jp, scores=Sj)
        assert _tree_rel(upd, jupd) < 1e-3
        tp = {k: tp[k] + upd[k] for k in tp}
        jp = {k: jnp.asarray(v) for k, v in params_to_arrays(tp).items()}
    assert float(tloss(tp)) < 0.5 * float(tloss(params_from_arrays(
        arrays, device="cpu")))


def test_ngd_curvature_policy_is_for_a_later_slice():
    # "exact" is the default: the same per-step solve
    S, g = torch.randn(4, 6), {"w": torch.randn(6)}
    upd = [opt.update(g, opt.init(g), g, scores=S)[0]["w"]
           for opt in (NaturalGradient(0.1, curvature="exact"),
                       NaturalGradient(0.1))]
    assert torch.equal(*upd)
    # a policy without solve() is refused with the reference's ValueError;
    # a StreamingCurvature is taken and its state rides in NGDState
    with pytest.raises(ValueError, match="curvature="):
        NaturalGradient(0.1, curvature=object())
    opt = NaturalGradient(0.1, curvature=StreamingCurvature(4, device="cpu"))
    st = opt.init(g)
    assert st.curvature.stats.refreshes == 0
    _, st = opt.update(g, st, g, scores=S)
    assert (st.curvature.stats.refreshes, st.curvature.stats.hits) == (1, 0)


def test_ngd_rejects_misaligned_blocks():
    _, _, _, _, tp, tb, tlogp, tloss = logreg_problem()
    S = per_sample_score_blocks(tlogp, tp, tb)
    swapped = BlockedScores(S.blocks[::-1])
    opt = NaturalGradient(0.5)
    with pytest.raises(ValueError, match="block widths"):
        opt.update(torch.func.grad(tloss)(tp), opt.init(tp), tp,
                   scores=swapped)


# ---------------------------------------------------------------------------
# schedules, AdamW, parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 10, 57, 110, 200])
def test_schedules_match_jax(step):
    pairs = [
        (warmup_cosine(1.0, warmup_steps=10, total_steps=110),
         joptim.warmup_cosine(1.0, warmup_steps=10, total_steps=110)),
        (warmup_linear(2.0, warmup_steps=4, total_steps=24),
         joptim.warmup_linear(2.0, warmup_steps=4, total_steps=24)),
        (constant(0.3), joptim.constant(0.3)),
    ]
    for ts, js in pairs:
        t = ts(step)
        assert t.dtype == torch.float32 and t.ndim == 0
        assert float(t) == pytest.approx(float(js(jnp.asarray(step))),
                                         rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_steps_match_jax(clip):
    rng = np.random.default_rng(9)
    arrays = {"x": rng.normal(size=(8,)).astype(np.float32),
              "m": {"k": rng.normal(size=(3, 2)).astype(np.float32)}}
    tp = params_from_arrays(arrays, device="cpu")
    jp = jax.tree.map(jnp.asarray, arrays)
    opt = AdamW(0.1, weight_decay=0.05, clip_grad_norm=clip)
    jopt = joptim.AdamW(0.1, weight_decay=0.05, clip_grad_norm=clip)
    st, jst = opt.init(tp), jopt.init(jp)
    for i in range(3):
        g = {"x": 3 * tp["x"] + i, "m": {"k": tp["m"]["k"] ** 2}}
        gj = {"x": 3 * jp["x"] + i, "m": {"k": jp["m"]["k"] ** 2}}
        upd, st = opt.update(g, st, tp)
        jupd, jst = jopt.update(gj, jst, jp)
        assert rel(upd["x"], jupd["x"]) < 1e-5
        assert rel(upd["m"]["k"], jupd["m"]["k"]) < 1e-5
        tp = {"x": tp["x"] + upd["x"], "m": {"k": tp["m"]["k"] + upd["m"]["k"]}}
        jp = jax.tree.map(jnp.add, jp, jupd)
    assert st.step == 3 and rel(st.nu["x"], jst.nu["x"]) < 1e-5


def test_params_round_trip_and_device_rule():
    arrays, *_ = mlp_problem()
    arrays = {**arrays, "nested": {"z": np.arange(6, dtype=np.float32)
                                   .reshape(2, 3)}}
    tp = params_from_arrays(arrays, device="cpu")
    assert tp["w1"].shape == (8, 16)          # the JAX layout, not nn.Linear's
    back = params_to_arrays(tp)
    assert sorted(back) == sorted(arrays)
    for k in ("w1", "b1", "w2", "b2", "w3"):
        assert back[k].dtype == np.float32 and np.array_equal(back[k], arrays[k])
    assert np.array_equal(back["nested"]["z"], arrays["nested"]["z"])
    # bf16 arrays, as jax.device_get gives them, keep their bits
    jb = np.asarray(jnp.asarray(arrays["w2"], jnp.bfloat16))
    tb = params_from_arrays({"w": jb}, device="cpu")["w"]
    assert tb.dtype == torch.bfloat16
    assert np.array_equal(params_to_arrays({"w": tb})["w"],
                          jb.astype(np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_arrays(arrays)
        with pytest.raises(RuntimeError, match="CUDA"):
            per_sample_score_blocks(lambda p, ex: p["w1"].sum(), arrays,
                                    (np.ones((4, 8), np.float32),))
