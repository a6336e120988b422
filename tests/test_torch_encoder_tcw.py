"""K1's wide bf16 instance on the tensor cores (``"tcw"``, ``csrc/encoder_tcw.cu``)
on the CPU: its weight pack, its tile plan, and its order of sums.

The kernels run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 2). What surrounds them is held here: the packed [128 out, 64 in] chunks
must hold each weight at the byte the products read; the plan's stats blocks
(the value blocks of a 64-channel tile) and attention blocks (the k chunks and
the at most 8 heads of a 128-column block) must cover every same-head pair; and
the layer computed in the plan's order (K'^T[V|1] partials per group of 16
source chunks, summed in group order; the attention over each block's k chunks
only; each LayerNorm from per-128-column (mean, M2) partials merged in block
order) must reproduce the plain version.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (
    TCW_BLOCK,
    TCW_SOURCE_GROUP,
    TCW_TILE,
    _elu_p1,
    encoder_layer_plain,
    pack_weight_chunks_tcw,
    tcw_head_chunks,
    tcw_takes,
    tcw_value_blocks,
)

torch.set_num_threads(2)

TCW_WIDTHS = [(128, 8), (256, 4), (384, 8), (512, 8), (512, 1), (640, 8), (768, 8), (1024, 8), (2048, 16),
              (4096, 16), (4096, 32), (192, 12), (320, 20)]


@pytest.mark.parametrize("n,k", [(640, 640), (1280, 640), (192, 128), (256, 512)])
def test_tcw_weight_pack_matches_the_byte_formula(n, k):
    """Element (n, k) of a [N out, K in] weight lies in chunk (n // 128, k // 64)
    of 16 KB at byte ((n % 128) // 8) * 1024 + ((k % 64) // 8) * 128 + (n % 8) * 16
    + (k % 8) * 2; rows past N (to a multiple of 128) are zero."""
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_weight_chunks_tcw(w)
    nb = -(-n // 128)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (nb, k // 64, 16, 8, 8, 8)
    words = packed.view(torch.int16).numpy().view(np.uint16).reshape(-1)
    r = np.arange(n)[:, None]
    c = np.arange(k)[None, :]
    byte = (((r // 128) * (k // 64) + c // 64) * 16384 + ((r % 128) // 8) * 1024 + ((c % 64) // 8) * 128
            + (r % 8) * 16 + (c % 8) * 2)
    want = w.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(words[byte // 2], want)
    assert np.count_nonzero(words) == np.count_nonzero(want)  # the rest is zero padding


@pytest.mark.parametrize("c,nhead", TCW_WIDTHS)
def test_tcw_plan_covers_every_same_head_pair(c, nhead):
    """Every (d, e) pair of channels in one head lies in a stats block of d's
    tile; every attention column's head channels lie in its block's k chunks,
    and a block has at most the 8 sum rows' heads."""
    assert tcw_takes(c, nhead)
    hd = c // nhead
    head = np.arange(c) // hd
    for i in range(c // TCW_TILE):
        lo, hi = tcw_value_blocks(i, hd)
        d = np.arange(TCW_TILE * i, TCW_TILE * (i + 1))
        e = np.flatnonzero(np.isin(head, head[d]))  # channels that share a head with the tile
        assert lo * TCW_BLOCK <= e.min() and e.max() < min(c, (hi + 1) * TCW_BLOCK)
        assert hi - lo + 1 <= 1 + -(-(2 * hd + TCW_TILE) // TCW_BLOCK)
    for nb in range(-(-c // TCW_BLOCK)):
        h_first, h_last, k_lo, k_hi = tcw_head_chunks(nb, c, hd)
        cols = np.arange(nb * TCW_BLOCK, min(c, (nb + 1) * TCW_BLOCK))
        assert h_first == head[cols].min() and h_last == head[cols].max() and h_last - h_first < 8
        ch = np.flatnonzero(np.isin(head, head[cols]))
        assert k_lo * TCW_TILE <= ch.min() and ch.max() < k_hi * TCW_TILE <= c


def _layernorm_by_blocks(raw, scale, bias):
    """LayerNorm over the last dimension from per-128-column (mean, M2)
    partials merged in block order (Chan's formula), as the kernel's row
    statistics; biased variance, eps 1e-5."""
    c = raw.shape[-1]
    mean = m2 = cnt = None
    for j in range(0, c, TCW_BLOCK):
        blk = raw[..., j:j + TCW_BLOCK]
        bn = blk.shape[-1]
        bm = blk.sum(-1) * (1.0 / bn)
        bm2 = ((blk - bm[..., None]) ** 2).sum(-1)
        if mean is None:
            mean, m2, cnt = bm, bm2, bn
            continue
        tot = cnt + bn
        delta = bm - mean
        mean = mean + delta * (bn / tot)
        m2 = m2 + bm2 + delta * delta * (cnt * bn / tot)
        cnt = tot
    rstd = torch.rsqrt(m2 / c + 1e-5)
    return (raw - mean[..., None]) * rstd[..., None] * scale + bias


def tcw_layer_by_the_plan(x, source, w, x_mask, source_mask, nhead, dtype):
    """The layer in the wide instance's order of sums, with product operands
    rounded to ``dtype`` as the kernels round them (f32 arithmetic)."""
    wq, wk, wv, wm, ln1s, ln1b, w0, w1, ln2s, ln2b = w  # [in, out]
    n, l, c = x.shape
    s, hd = source.shape[1], c // nhead

    def r(t):
        return t.to(dtype).float()

    xb, sb = r(x), r(source)
    k = _elu_p1(sb @ r(wk))
    if source_mask is not None:
        k = k * source_mask[..., None]
    kp, v = r(k), r(sb @ r(wv))
    head = torch.arange(c) // hd
    # stats: each group's partials of the same-head blocks of K'^T V and sum K',
    # over the value blocks of each 64-channel tile only; groups summed in order
    group_rows = TCW_SOURCE_GROUP * TCW_TILE
    total = None
    for g0 in range(0, s, group_rows):
        kg, vg = kp[:, g0:g0 + group_rows], v[:, g0:g0 + group_rows]
        part = torch.zeros(n, c, hd + 1)
        for i in range(c // TCW_TILE):
            lo, hi = tcw_value_blocks(i, hd)
            d = torch.arange(TCW_TILE * i, TCW_TILE * (i + 1))
            e = torch.arange(lo * TCW_BLOCK, min(c, (hi + 1) * TCW_BLOCK))
            prod = kg[:, :, d].transpose(1, 2) @ vg[:, :, e]  # [n, 64, E]
            for a, dd in enumerate(d.tolist()):
                same = head[e] == head[dd]
                part[:, dd, e[same] - head[dd] * hd] = prod[:, a, same]
            part[:, d, hd] = kg[:, :, d].sum(1)
        total = part if total is None else total + part
    kvr = r(total)  # the attention's B image
    bd = torch.zeros(n, c, c)  # block-diagonal KV, [channel d, value column e]
    for h in range(nhead):
        sl = slice(h * hd, (h + 1) * hd)
        bd[:, sl, sl] = kvr[:, sl, :hd]
    q = _elu_p1(xb @ r(wq))
    if x_mask is not None:
        q = q * x_mask[..., None]
    qp = r(q)
    msg = torch.empty(n, l, c)
    for nb in range(-(-c // TCW_BLOCK)):
        h_first, h_last, k_lo, k_hi = tcw_head_chunks(nb, c, hd)
        cols = torch.arange(nb * TCW_BLOCK, min(c, (nb + 1) * TCW_BLOCK))
        ks = torch.arange(k_lo * TCW_TILE, k_hi * TCW_TILE)
        sums = torch.zeros(n, len(ks), 8)  # the 8 rows of sum K'_h of the block's heads
        for i, h in enumerate(range(h_first, h_last + 1)):
            sums[:, :, i] = kvr[:, ks, hd] * (head[ks] == h)
        num = qp[:, :, ks] @ bd[:, ks][:, :, cols]
        den = qp[:, :, ks] @ sums
        inv = 1.0 / (den[..., head[cols] - h_first] + 1e-6)
        msg[:, :, cols] = r(num * inv)
    h1 = _layernorm_by_blocks(msg @ r(wm), ln1s, ln1b)
    hid = r(torch.relu(torch.cat([xb, r(h1)], dim=-1) @ r(w0)))
    return x + _layernorm_by_blocks(hid @ r(w1), ln2s, ln2b)


def _layer_inputs(c, n, l, s, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)]
    w0, w1 = rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), rn(2 * c, c, scale=(2 * c) ** -0.5)
    weights = (*w, 1 + rn(c, scale=0.1), rn(c, scale=0.1), w0, w1, 1 + rn(c, scale=0.1), rn(c, scale=0.1))
    x, src = rn(n, l, c), rn(n, s, c)
    masks = (torch.from_numpy(rng.random((n, l)) > 0.3).float(), torch.from_numpy(rng.random((n, s)) > 0.3).float())
    return x, src, weights, masks


@pytest.mark.parametrize("c,nhead", [(256, 4), (640, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tcw_order_of_sums_reproduces_the_plain_version(c, nhead, dtype):
    """Ragged L, two source groups (S = 1100 rows: 18 chunks of 64, groups of
    16), masks. With f32 operands the plan only reorders f32 sums (1e-4); with
    bf16 operands a rounded operand may land on the neighbouring bf16 value,
    so the kernels' tolerances hold (max 5e-2, mean 5e-3)."""
    x, src, w, (xm, sm) = _layer_inputs(c, 2, 97, 1100, seed=c)
    got = tcw_layer_by_the_plan(x, src, w, xm, sm, nhead, dtype)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=dtype)
    d = (got - ref).abs()
    if dtype == torch.float32:
        assert d.max().item() < 1e-4, d.max().item()
    else:
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3, (d.max().item(), d.mean().item())


def test_tcw_layernorm_partials_match_layer_norm():
    """The row statistics from (mean, M2) partials of 128 columns (the last
    block 64 wide at C = 320) are as close to a float64 LayerNorm as
    F.layer_norm's in f32, also for rows with a large common offset (where f32
    itself loses digits: x - mean of values near 300)."""
    rng = np.random.default_rng(5)
    offset = torch.tensor([0.0, 30.0, -300.0])[:, None, None]
    raw = torch.from_numpy(rng.standard_normal((3, 50, 320)).astype(np.float32)) + offset
    scale = torch.from_numpy(rng.standard_normal(320).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(320).astype(np.float32))
    exact = F.layer_norm(raw.double(), (320,), scale.double(), bias.double(), 1e-5)
    got = (_layernorm_by_blocks(raw, scale, bias).double() - exact).abs()
    ref = (F.layer_norm(raw, (320,), scale, bias, 1e-5).double() - exact).abs()
    for b_ in range(3):
        assert got[b_].max().item() <= 1.5 * ref[b_].max().item() + 1e-6, (b_, got[b_].max(), ref[b_].max())
    assert got[0].max().item() < 1e-5
