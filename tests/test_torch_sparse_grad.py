"""Row-sparse embedding gradients of the port against the JAX package on
the CPU: every case of ``tests/test_sparse_grad.py`` (17), each run
through both packages on copied weights and the same numpy ids, plus
the 4-step eager Llama run with ``sparse_embed`` (losses within 1e-5 of
JAX's) and ``TrainStep`` keeping the embedding dense.  fp32 (the CPU's
sparse add has no bf16); tolerances as stated in each test."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.sparse_grad import RowSparseGrad as JRowSparseGrad

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.sparse_grad import RowSparseGrad, is_row_sparse

TOL = 1e-5


def _embeds(vocab=32, d=8, sparse=True, padding_idx=None, seed=0):
    """A JAX embedding and the port's with the same weight."""
    pp.seed(seed)
    je = pp.nn.Embedding(vocab, d, padding_idx=padding_idx, sparse=sparse)
    te = tp.nn.Embedding(vocab, d, padding_idx=padding_idx, sparse=sparse)
    te.set_state_dict({"weight": np.asarray(je.weight._data)})
    return je, te


def _ids(a):
    a = np.asarray(a, np.int32)
    return pp.to_tensor(a), torch.from_numpy(a.astype(np.int64))


def _dense(g):
    if isinstance(g, JRowSparseGrad):
        return np.asarray(g.to_dense())
    if is_row_sparse(g):
        return RowSparseGrad.of(g).to_dense().numpy()
    return g.numpy() if torch.is_tensor(g) else np.asarray(g._data)


# -- TestRowSparseGrad --------------------------------------------------------

def test_backward_produces_sparse_grad():
    je, te = _embeds()
    ji, ti = _ids([[1, 2, 2, 5]])
    je(ji).sum().backward()
    te(ti).sum().backward()
    g = te.weight.grad
    assert g.layout == torch.sparse_coo
    rs = RowSparseGrad.of(g)
    assert rs.nnz_rows == je.weight.grad.nnz_rows == 4   # duplicates kept
    assert rs.shape == tuple(te.weight.shape)
    np.testing.assert_allclose(_dense(g), _dense(je.weight.grad), rtol=TOL)


def test_sparse_grad_matches_dense():
    je, te = _embeds()
    _, td = _embeds(sparse=False)
    ji, ti = _ids([[3, 7, 3], [0, 1, 7]])
    (je(ji) ** 2).sum().backward()
    (te(ti) ** 2).sum().backward()
    (td(ti) ** 2).sum().backward()
    assert td.weight.grad.layout == torch.strided
    np.testing.assert_allclose(_dense(te.weight.grad), td.weight.grad.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(_dense(te.weight.grad),
                               _dense(je.weight.grad), rtol=TOL)


def test_coalesce_sums_duplicates():
    g = RowSparseGrad(torch.tensor([2, 5, 2]),
                      torch.tensor([[1.0], [2.0], [3.0]]), (8, 1))
    jg = JRowSparseGrad(np.array([2, 5, 2]),
                        np.array([[1.0], [2.0], [3.0]], np.float32), (8, 1))
    c, jc = g.coalesce(), jg.coalesce()
    assert c.nnz_rows == jc.nnz_rows == 2
    assert c.coalesce() is c
    np.testing.assert_array_equal(c.rows.numpy(), np.asarray(jc.rows))
    np.testing.assert_allclose(c.values.numpy(), np.asarray(jc.values))
    np.testing.assert_allclose(c.to_dense().numpy(), g.to_dense().numpy())


def test_accumulation_across_backwards():
    je, te = _embeds()
    ji, ti = _ids([[1, 2]])
    for e, i in ((je, ji), (te, ti)):
        e(i).sum().backward()
        e(i).sum().backward()
    g = te.weight.grad
    assert is_row_sparse(g)
    assert RowSparseGrad.of(g).nnz_rows == 4   # concatenated, not summed
    dense = _dense(g)
    np.testing.assert_allclose(dense, _dense(je.weight.grad), rtol=TOL)
    assert dense[1].sum() == pytest.approx(2.0 * te.weight.shape[1])


def test_padding_idx_gets_no_grad():
    je, te = _embeds(16, 4, padding_idx=0)
    ji, ti = _ids([[0, 3]])
    je(ji).sum().backward()
    out = te(ti)
    assert not out[0, 0].any()
    out.sum().backward()
    dense = _dense(te.weight.grad)
    np.testing.assert_allclose(dense[0], 0.0)
    assert dense[3].sum() != 0.0
    np.testing.assert_allclose(dense, _dense(je.weight.grad), rtol=TOL)


# -- TestSparseOptimizers -----------------------------------------------------

def _train(pkg, opt_name, sparse, steps=3, **opt_kw):
    """The JAX case's loop (3 steps of ``(e(ids) ** 2).sum()``, lr 0.1)
    through package `pkg` ("jax" or "torch") from the same weights."""
    je, te = _embeds(32, 8, sparse=sparse, seed=0)
    rng = np.random.default_rng(0)
    if pkg == "jax":
        e, opt_mod, wrap = je, pp.optimizer, lambda a: pp.to_tensor(a)
    else:
        e, opt_mod, wrap = te, tp.optimizer, \
            lambda a: torch.from_numpy(a.astype(np.int64))
    kw = dict(opt_kw)
    if "clip" in kw:
        kw["grad_clip"] = kw.pop("clip")(pkg)
    opt = getattr(opt_mod, opt_name)(learning_rate=0.1,
                                     parameters=e.parameters(), **kw)
    for _ in range(steps):
        ids = wrap(rng.integers(0, 32, (4, 6)).astype("int32"))
        (e(ids) ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
    return np.asarray(e.weight._data) if pkg == "jax" else \
        e.weight.detach().numpy()


def _parity(opt_name, **kw):
    """Port sparse == JAX sparse (1e-5 relative, 1e-6 absolute: the
    updates of three steps, fp32), and port sparse == port dense within
    1e-5 absolute: the port's dense Adam is the multi-tensor rule, whose
    bias corrections are fp32 powers (the JAX step's), while the sparse
    rule takes JAX's sparse rule's Python-float ones, an ulp apart, which
    moves an update of order lr by up to ~2e-6."""
    got = _train("torch", opt_name, True, **kw)
    np.testing.assert_allclose(got, _train("jax", opt_name, True, **kw),
                               rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(got, _train("torch", opt_name, False, **kw),
                               rtol=TOL, atol=1e-5)


def test_sgd_parity():
    _parity("SGD")


def test_sgd_weight_decay_touches_rows_only():
    je, te = _embeds(8, 2)
    w0 = te.weight.detach().numpy().copy()
    jopt = pp.optimizer.SGD(learning_rate=0.1, parameters=je.parameters(),
                            weight_decay=0.5)
    topt = tp.optimizer.SGD(learning_rate=0.1, parameters=te.parameters(),
                            weight_decay=0.5)
    ji, ti = _ids([[1]])
    je(ji).sum().backward()
    te(ti).sum().backward()
    jopt.step()
    topt.step()
    w1 = te.weight.detach().numpy()
    np.testing.assert_array_equal(w1[0], w0[0])   # untouched: no decay
    assert not np.allclose(w1[1], w0[1])
    np.testing.assert_allclose(w1, np.asarray(je.weight._data), rtol=TOL)


def test_adam_nonlazy_parity():
    """lazy_mode=False matches dense Adam (moments decay everywhere)."""
    _parity("Adam")


def test_adamw_nonlazy_parity():
    _parity("AdamW")


def test_adam_lazy_touches_rows_only():
    je, te = _embeds(8, 2)
    w0 = te.weight.detach().numpy().copy()
    jopt = pp.optimizer.Adam(learning_rate=0.1, lazy_mode=True,
                             parameters=je.parameters())
    topt = tp.optimizer.Adam(learning_rate=0.1, lazy_mode=True,
                             parameters=te.parameters())
    ji, ti = _ids([[2, 5]])
    je(ji).sum().backward()
    te(ti).sum().backward()
    jopt.step()
    topt.step()
    w1 = te.weight.detach().numpy()
    for r in range(8):
        if r in (2, 5):
            assert not np.allclose(w1[r], w0[r])
        else:
            np.testing.assert_array_equal(w1[r], w0[r])
    np.testing.assert_allclose(w1, np.asarray(je.weight._data), rtol=TOL)


def test_adam_lazy_matches_dense_on_touched_rows_first_step():
    """From zero moments, lazy Adam's touched rows equal dense Adam's:
    JAX's lazy rows within 1e-5, the port's dense rows within 1e-5
    relative and 1e-6 absolute (its fp32-power bias corrections, an ulp
    from the sparse rule's, move a 0.1 update by up to ~7e-7)."""
    je, ts = _embeds()
    _, td = _embeds(sparse=False)
    jopt = pp.optimizer.Adam(learning_rate=0.1, lazy_mode=True,
                             parameters=je.parameters())
    opt_s = tp.optimizer.Adam(learning_rate=0.1, lazy_mode=True,
                              parameters=ts.parameters())
    opt_d = tp.optimizer.Adam(learning_rate=0.1, parameters=td.parameters())
    ji, ti = _ids([[4, 9, 4]])
    (je(ji) ** 2).sum().backward()
    (ts(ti) ** 2).sum().backward()
    (td(ti) ** 2).sum().backward()
    jopt.step()
    opt_s.step()
    opt_d.step()
    ws, wd = ts.weight.detach().numpy(), td.weight.detach().numpy()
    wj = np.asarray(je.weight._data)
    for r in (4, 9):
        np.testing.assert_allclose(ws[r], wj[r], rtol=TOL)
        np.testing.assert_allclose(ws[r], wd[r], rtol=TOL, atol=1e-6)


def _clip(kind, value):
    return lambda pkg: getattr(pp.nn if pkg == "jax" else tp.nn,
                               kind)(value)


def test_global_norm_clip_parity():
    _parity("SGD", clip=_clip("ClipGradByGlobalNorm", 0.01))


def test_by_norm_clip_parity():
    _parity("SGD", clip=_clip("ClipGradByNorm", 0.01))


def test_by_value_clip_parity():
    _parity("SGD", clip=_clip("ClipGradByValue", 0.05))


# -- TestSparseGates ----------------------------------------------------------

def test_non_leaf_weight_falls_back_to_dense():
    _, te = _embeds(16, 4)
    w2 = te.weight * 1.0                   # non-leaf
    _, ti = _ids([[1, 2]])
    TF.embedding(ti, w2, sparse=True).sum().backward()
    assert te.weight.grad is not None
    assert te.weight.grad.layout == torch.strided


def test_name_kwarg_accepted():
    je, te = _embeds(16, 4)
    ji, ti = _ids([[1]])
    out = TF.embedding(ti, te.weight, name="emb")
    assert tuple(out.shape) == (1, 1, 4)
    np.testing.assert_allclose(
        out.detach().numpy(), JF.embedding(ji, je.weight, name="emb").numpy())


# -- TestLlamaSparseEmbed -----------------------------------------------------

def _llamas(sparse=True):
    from paddle_tpu.models import LlamaConfig as JCfg
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    pp.seed(0)
    # one layer (JAX's case has two): the JAX eager tape's steps dominate
    # this file's time
    jcfg = JCfg.tiny(vocab_size=64, num_hidden_layers=1)
    jcfg.sparse_embed = sparse
    jm = JLlama(jcfg)
    cfg = LlamaConfig.tiny(vocab_size=64, num_hidden_layers=1,
                           sparse_embed=sparse)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def test_llama_eager_step_with_sparse_embed():
    """Four eager AdamW(lazy_mode) steps of the tiny Llama with
    ``sparse_embed``: the embedding's gradient row-sparse every step in
    both packages, the losses within 1e-5 of JAX's, falling."""
    jm, tm = _llamas()
    assert tm.model.embed_tokens._sparse
    jopt = pp.optimizer.AdamW(learning_rate=1e-3, lazy_mode=True,
                              parameters=jm.parameters())
    topt = tp.optimizer.AdamW(learning_rate=1e-3, lazy_mode=True,
                              parameters=tm.parameters())
    ids = np.random.default_rng(0).integers(0, 64, (2, 17))
    x, y = ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")
    jl, tl = [], []
    for _ in range(4):
        jloss = jm.loss(pp.to_tensor(x), pp.to_tensor(y))
        jloss.backward()
        assert isinstance(jm.model.embed_tokens.weight.grad, JRowSparseGrad)
        jopt.step()
        jopt.clear_grad()
        jl.append(float(jloss))
        tloss = tm.loss(torch.from_numpy(x).long(), torch.from_numpy(y).long())
        tp.autograd.backward(tloss)
        g = tm.model.embed_tokens.weight.grad
        assert is_row_sparse(g) and RowSparseGrad.of(g).nnz_rows == x.size
        topt.step()
        topt.clear_grad()
        tl.append(float(tloss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(),
                                   jm.state_dict()[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_train_step_runs_the_sparse_embedding_dense():
    """TrainStep sets the substitution flag: the sparse_embed model's two
    steps are bitwise the sparse_embed=False model's."""
    from paddle_tpu_torch.jit import TrainStep
    _, ts = _llamas(sparse=True)
    _, td = _llamas(sparse=False)
    ids = np.random.default_rng(1).integers(0, 64, (2, 17))
    batch = {"input_ids": torch.from_numpy(ids[:, :-1]),
             "labels": torch.from_numpy(ids[:, 1:])}
    steps = [TrainStep(m, tp.optimizer.AdamW(learning_rate=1e-3))
             for m in (ts, td)]
    for _ in range(2):
        la, lb = (float(s(batch)) for s in steps)
        assert la == lb
    for (n, a), (_, b) in zip(ts.state_dict().items(),
                              td.state_dict().items()):
        assert torch.equal(a, b), n


def test_row_sparse_grad_api():
    rows = torch.tensor([3, 1, 3])
    vals = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    g = RowSparseGrad(rows, vals, (5, 2))
    t = g.to_torch()
    assert t.layout == torch.sparse_coo and t._values().data_ptr() == \
        vals.data_ptr()                     # no copy either way
    back = RowSparseGrad.of(t)
    assert back.values.data_ptr() == vals.data_ptr()
    assert g.dtype == torch.float32 and g.nnz_rows == 3
    np.testing.assert_allclose(g.to_dense().numpy(), t.to_dense().numpy())
    np.testing.assert_allclose(g.scale(2.0).to_dense().numpy(),
                               2 * g.to_dense().numpy())
    assert g.astype("float64").dtype == torch.float64
    s = g + g
    assert s.nnz_rows == 6 and not s.coalesced
    np.testing.assert_allclose((g + torch.ones(5, 2)).numpy(),
                               g.to_dense().numpy() + 1)
    with pytest.raises(ValueError):
        RowSparseGrad(rows, torch.zeros(3, 4), (5, 2))


def test_grad_scaler_unscales_sparse_values():
    """The JAX GradScaler fails on a RowSparseGrad; the port's unscales
    its values and finds infs in them."""
    _, te = _embeds(16, 4)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=te.parameters())
    scaler = tp.amp.GradScaler(init_loss_scaling=8.0)
    _, ti = _ids([[1, 2, 2]])
    scaler.scale(te(ti).sum()).backward()
    scaler.unscale_(opt)
    np.testing.assert_allclose(_dense(te.weight.grad)[2], 2.0)
    assert not scaler._found_inf
