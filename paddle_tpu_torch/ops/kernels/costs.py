"""What each kernel costs: ``(flops, bytes, products)`` of one call, the
numbers behind the bound of ``PERF.md``'s kernel table and
``chip_smoke.py``'s ``bound_ms``.  Bytes count each input read once and
each output written once; the FLOPs are those the function needs for
these inputs (a causal product is half the dense one, the paged decode
reads the live tokens only, the grouped FFN computes the routed rows
only); `products` says whether they are matrix-product FLOPs.  The
wrappers charge these to the cost model's counter (``_build.charge``);
the paged decode and the grouped FFN read their lengths and counts from
the device to do so, which only a counting run pays."""

from __future__ import annotations

__all__ = ["qkv", "mlp", "ffn", "paged", "quant_matmul", "flash_fwd",
           "flash_dq", "flash_dkv", "ce_fwd", "ce_bwd", "rmsnorm",
           "grouped", "decoder", "mt_norm", "mt_adam", "mt_digest",
           "MT_OPS"]

# fp32 operations a parameter of the multi-tensor update: the clip's
# multiply, the two moments (6), both bias corrections (2), sqrt, eps,
# the quotient, the decay (2), the step (2)
MT_OPS = 17


def _rows(x):
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def qkv(x, norm_weight, wq, wk, wv, residuals=False):
    """RMSNorm + QKV: x, the norm weight and the three weights read; q,
    k, v written (and xn, inv in the training variant)."""
    T, d, i = _rows(x), x.shape[-1], x.element_size()
    n = wq.shape[1] + wk.shape[1] + wv.shape[1]
    nbytes = i * (T * d + d + d * n + T * n)
    if residuals:
        nbytes += i * T * d + 4 * T
    return 2 * T * d * n, nbytes, True


def mlp(x, w_gate, w_up, w_down):
    """The SwiGLU MLP: x and three weights read, y written."""
    T, d, f, i = _rows(x), x.shape[-1], w_gate.shape[1], x.element_size()
    return 6 * T * d * f, i * (2 * T * d + 3 * d * f), True


def ffn(x, w1, w2, b1=None, b2=None):
    """``act(x @ w1 + b1) @ w2 + b2``: x, both weights and both biases
    read (zeros where None, as the wrapper passes them), y written."""
    T, d, f, i = _rows(x), x.shape[-1], w1.shape[1], x.element_size()
    return 4 * T * d * f, i * (2 * T * d + 2 * d * f + f + d), True


def paged(q, k_pool, block_table, lengths, k_scale=None):
    """Paged decode over the live tokens: q read and the output written,
    each live token's K and V (and their int8 scales) read once, the
    table and the lengths read."""
    B, h, hd = q.shape
    kvh = k_pool.shape[2]
    tokens = int(lengths.sum())
    per_token = kvh * 2 * (hd * k_pool.element_size()
                           + (4 if k_scale is not None else 0))
    nbytes = q.element_size() * 2 * B * h * hd + tokens * per_token + \
        4 * (block_table.numel() + B)
    return 4 * tokens * h * hd, nbytes, True


def quant_matmul(x, qw, scale):
    """x read, the stored weight (one byte an element) and its fp32
    scales read, y written."""
    K, N, i = x.shape[-1], qw.shape[1], x.element_size()
    T = _rows(x)
    return 2 * T * K * N, T * K * i + K * N * qw.element_size() + 4 * N + \
        T * N * i, True


def _flash(q, k, causal):
    b, s, h, d = q.shape
    qb = q.numel() * q.element_size()
    kvb = k.numel() * k.element_size()
    stat = b * h * s * 4
    prod = 2 * b * h * s * s * d // (2 if causal else 1)
    return qb, kvb, stat, prod


def flash_fwd(q, k, v, causal=False):
    """q, k, v read; out and lse written; two products."""
    qb, kvb, stat, prod = _flash(q, k, causal)
    return 2 * prod, qb + 2 * kvb + qb + stat, True


def flash_dq(q, k, v, causal=False):
    """q, k, v, dout, lse and delta read; dq written; three products."""
    qb, kvb, stat, prod = _flash(q, k, causal)
    return 3 * prod, qb + 2 * kvb + qb + 2 * stat + qb, True


def flash_dkv(q, k, v, causal=False):
    """q, k, v, dout, lse and delta read; dk and dv written; four
    products."""
    qb, kvb, stat, prod = _flash(q, k, causal)
    return 4 * prod, qb + 2 * kvb + qb + 2 * stat + 2 * kvb, True


def ce_fwd(logits):
    """The logits and the int64 labels read once, loss and lse (fp32)
    written; 4 fp32 operations an element."""
    T, V = logits.shape
    return 4 * T * V, T * V * logits.element_size() + 16 * T, False


def ce_bwd(logits):
    """The logits, the labels, lse and the cotangent read, dx
    written."""
    T, V = logits.shape
    return 4 * T * V, 2 * T * V * logits.element_size() + 16 * T, False


def rmsnorm(x, weight, residual=None):
    """x (and the residual) read, y (and h) written, the weight read and
    inv (fp32) written; 5 operations an element."""
    T, d, i = _rows(x), x.shape[-1], x.element_size()
    res = residual is not None
    return 5 * T * d, i * (T * d * (2 + 2 * res) + d) + 4 * T, False


def grouped(x, w1, b1, w2, b2, counts=None):
    """The routed rows read, every expert's weights and biases read, y
    written whole (zeros past the counts), the counts read."""
    G, C, d = x.shape
    E, _, h = w1.shape
    n = G * C if counts is None else int(counts.sum())
    i = x.element_size()
    nbytes = n * d * i + E * (2 * d * h + h + d) * i + G * C * d * i + 4 * G
    return 4 * n * d * h, nbytes, True


def decoder(x, wq, wk, wg, num_heads):
    """The whole block: x read and y written once, the weights once, the
    two fp32 RoPE tables' s rows; the products 2 T (d (dq + 2 dkv) + dq d
    + 3 d f) plus causal attention, 4 b h s^2 hd / 2."""
    b, s, d = x.shape
    dq, dkv, f = wq.shape[1], wk.shape[1], wg.shape[1]
    hd = dq // int(num_heads)
    w = d * (dq + 2 * dkv) + dq * d + 3 * d * f + 2 * d
    nbytes = x.element_size() * (2 * b * s * d + w) + 2 * 4 * s * hd // 2
    flops = 2 * b * s * (w - 2 * d) + \
        4 * b * int(num_heads) * s * s * hd // 2
    return flops, nbytes, True


def mt_norm(tensors):
    """Every tensor read once; two operations an element."""
    n = sum(t.numel() for t in tensors)
    return 2 * n, sum(t.numel() * t.element_size() for t in tensors), False


def mt_adam(params, grads, masters):
    """Each gradient and both fp32 moments read, the moments written,
    the parameter written and its master (or itself) read and written;
    ``MT_OPS`` operations a parameter."""
    n = sum(p.numel() for p in params)
    nbytes = sum(
        p.numel() * (g.element_size() + 16 + p.element_size()
                     + (8 if ma is not None else p.element_size()))
        for p, g, ma in zip(params, grads, masters))
    return MT_OPS * n, nbytes, False


def mt_digest(tensors):
    """Every leaf read once, the per-leaf sums and the digest (4 bytes
    each) written; one integer add an element."""
    n = sum(t.numel() for t in tensors)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return n, nbytes + 4 * (len(tensors) + 1), False
