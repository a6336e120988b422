"""K1's tensor-core chains on the CPU: bf16 (``"tcw"``, ``csrc/encoder_tcw.cu``)
and f32 in split TF32 (``"tcw_tf32"``, ``csrc/encoder_tcw_tf32.cu``), at every
width but (256, 8): their weight packs, their tile plans, and their order of
sums.

The kernels run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 2). What surrounds them is held here: the packed [128 out, 64 in] chunks
must hold each weight at the byte the products read, zero past N and past K;
the plan's stats blocks (the value blocks of a 64-channel tile) and attention
blocks (the k chunks and the at most 16 heads of a 128-column block, or the
64-column blocks with replicated denominators where the head width is not a
multiple of 8) must cover every same-head pair inside C padded to 64
channels; and the layer computed in the plan's order (K'^T[V|1] partials per
group of 16 source chunks, summed in group order; the attention over each
block's k chunks only; each LayerNorm from per-128-column (mean, M2) partials
merged in block order) must reproduce the plain version. The split-TF32 chain
keeps that plan at 32-channel k chunks (heads straddle them at head widths 24,
40 and 80) and an even k range, and computes every product as three TF32
products of hi / lo halves.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onepose_plus_plus_tpu_torch.kernels import tf32_split, tf32x3_matmul
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (
    TCW32_CHUNK,
    TCW32_SOURCE_GROUP,
    TCW_BLOCK,
    TCW_FILL,
    TCW_REP_BLOCK,
    TCW_SOURCE_GROUP,
    TCW_SUMS,
    TCW_TILE,
    _elu_p1,
    encoder_layer_plain,
    pack_weight_chunks_tcw,
    pack_weight_chunks_tcw_tf32,
    tcw32_head_chunks,
    tcw_head_chunks,
    tcw_padded,
    tcw_replicated,
    tcw_source_chunks,
    tcw_takes,
    tcw_value_blocks,
)

torch.set_num_threads(2)

# the widths both chains took from the CUDA-core kernels: head widths 8 and 24
# (16 sum rows), C = 32, 64, 96 and 160 (C padded to 64 channels), and head
# widths that are not a multiple of 8 (replicated denominators)
NARROW_WIDTHS = [(128, 16), (384, 16), (32, 1), (32, 4), (32, 8), (32, 32), (64, 1), (64, 2), (64, 8), (64, 16),
                 (96, 3), (96, 8), (96, 12), (96, 32), (160, 5), (160, 8), (160, 20), (160, 32), (224, 8),
                 (640, 160), (4064, 8)]
TCW_WIDTHS = [(128, 8), (256, 4), (384, 8), (512, 8), (512, 1), (640, 8), (768, 8), (1024, 8), (2048, 16),
              (4096, 16), (4096, 32), (192, 12), (320, 20)] + NARROW_WIDTHS
# the split-TF32 chain's widths with head widths 8, 24, 40, 80 and 128 besides
TCW32_WIDTHS = TCW_WIDTHS + [(128, 16), (256, 32), (4096, 512), (384, 16), (192, 8), (1920, 80), (640, 16),
                             (320, 8), (640, 8), (1280, 16), (512, 4), (4096, 32)]


@pytest.mark.parametrize("n,k", [(640, 640), (1280, 640), (192, 128), (256, 512), (192, 96), (64, 32), (136, 160),
                                 (320, 480)])
def test_tcw_weight_pack_matches_the_byte_formula(n, k):
    """Element (n, k) of a [N out, K in] weight lies in chunk (n // 128, k // 64)
    of 16 KB at byte ((n % 128) // 8) * 1024 + ((k % 64) // 8) * 128 + (n % 8) * 16
    + (k % 8) * 2; rows past N (to a multiple of 128) and input columns past K
    (to a multiple of 64) are zero."""
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_weight_chunks_tcw(w)
    nb, kc = -(-n // 128), tcw_padded(k) // 64
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (nb, kc, 16, 8, 8, 8)
    words = packed.view(torch.int16).numpy().view(np.uint16).reshape(-1)
    r = np.arange(n)[:, None]
    c = np.arange(k)[None, :]
    byte = (((r // 128) * kc + c // 64) * 16384 + ((r % 128) // 8) * 1024 + ((c % 64) // 8) * 128
            + (r % 8) * 16 + (c % 8) * 2)
    want = w.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(words[byte // 2], want)
    assert np.count_nonzero(words) == np.count_nonzero(want)  # the rest is zero padding


def _attention_block(c, hd):
    """The columns of an attention block: 64 with replicated denominators, else 128."""
    return TCW_REP_BLOCK if tcw_replicated(hd) else TCW_BLOCK


def _check_stats_plan(c, hd):
    """Every (d, e) pair of channels below C in one head lies in a stats block
    of d's 64-channel tile (the tiles of C padded to 64), inside V^T's column
    blocks."""
    head = np.arange(c) // hd
    for i in range(tcw_padded(c) // TCW_TILE):
        lo, hi = tcw_value_blocks(i, c, hd)
        d = np.arange(TCW_TILE * i, min(c, TCW_TILE * (i + 1)))
        e = np.flatnonzero(np.isin(head, head[d]))  # channels that share a head with the tile
        assert lo * TCW_BLOCK <= e.min() and e.max() < min(c, (hi + 1) * TCW_BLOCK)
        assert hi - lo + 1 <= 1 + -(-(2 * hd + TCW_TILE) // TCW_BLOCK) and hi < -(-c // TCW_BLOCK)


@pytest.mark.parametrize("c,nhead", TCW_WIDTHS)
def test_tcw_plan_covers_every_same_head_pair(c, nhead):
    """Every (d, e) pair of channels in one head lies in a stats block of d's
    tile; every attention column's head channels lie in its block's k chunks,
    inside C padded to 64 channels, and a 128-column block has at most the 16
    sum rows' heads (a 64-column block with replicated denominators any number)."""
    assert tcw_takes(c, nhead)
    hd = c // nhead
    head = np.arange(c) // hd
    _check_stats_plan(c, hd)
    block = _attention_block(c, hd)
    for nb in range(-(-c // block)):
        h_first, h_last, k_lo, k_hi = tcw_head_chunks(nb, c, hd, block=block)
        cols = np.arange(nb * block, min(c, (nb + 1) * block))
        assert h_first == head[cols].min() and h_last == head[cols].max()
        assert tcw_replicated(hd) or h_last - h_first < TCW_SUMS
        ch = np.flatnonzero(np.isin(head, head[cols]))
        assert k_lo * TCW_TILE <= ch.min() and ch.max() < k_hi * TCW_TILE <= tcw_padded(c)


@pytest.mark.parametrize("n,k", [(640, 640), (1280, 640), (192, 128), (256, 512), (136, 96), (64, 32), (192, 160),
                                 (320, 480)])
def test_tcw_tf32_weight_pack_matches_the_byte_formula(n, k):
    """Element (n, k) of a [N out, K in] f32 weight lies in chunk (n // 128, k // 32)
    of 2 x 16 KB, its TF32 hi part in the first half and its lo part in the
    second, at byte ((n % 128) // 8) * 1024 + ((k % 32) // 4) * 128 + (n % 8) * 16
    + (k % 4) * 4 of the half; hi + lo is the weight to ~2^-22; rows past N (to a
    multiple of 128) and input columns past K (to a multiple of 64: an even
    chunk count) are zero."""
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    packed = pack_weight_chunks_tcw_tf32(w)
    nb, kc = -(-n // 128), tcw_padded(k) // 32
    assert packed.dtype == torch.float32 and packed.is_contiguous() and kc % 2 == 0
    assert tuple(packed.shape) == (nb, kc, 2, 16, 8, 8, 4)
    words = packed.view(torch.int32).numpy().reshape(-1)
    r = np.arange(n)[:, None]
    c = np.arange(k)[None, :]
    byte = (((r // 128) * kc + c // 32) * 32768 + ((r % 128) // 8) * 1024 + ((c % 32) // 4) * 128
            + (r % 8) * 16 + (c % 4) * 4)
    hi, lo = tf32_split(w)
    np.testing.assert_array_equal(words[byte // 4], hi.view(torch.int32).numpy())
    np.testing.assert_array_equal(words[(byte + 16384) // 4], lo.view(torch.int32).numpy())
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double() - w.double()).abs() <= 2.0 ** -21 * w.double().abs()).all()
    assert np.count_nonzero(words) == int(hi.ne(0).sum() + lo.ne(0).sum())  # the rest is zero padding


@pytest.mark.parametrize("c,nhead", TCW32_WIDTHS)
def test_tcw32_plan_covers_every_same_head_pair(c, nhead):
    """The split-TF32 chain's plan: every (d, e) pair of channels in one head lies
    in a stats block of d's tile; every attention column's head channels lie in
    its block's 32-channel k chunks, an even number of them inside C padded to
    64 channels, and a 128-column block has at most the 16 sum rows' heads."""
    assert tcw_takes(c, nhead)
    hd = c // nhead
    head = np.arange(c) // hd
    _check_stats_plan(c, hd)
    block = _attention_block(c, hd)
    for nb in range(-(-c // block)):
        h_first, h_last, k_lo, k_hi = tcw32_head_chunks(nb, c, hd, block)
        cols = np.arange(nb * block, min(c, (nb + 1) * block))
        assert h_first == head[cols].min() and h_last == head[cols].max()
        assert tcw_replicated(hd) or h_last - h_first < TCW_SUMS
        ch = np.flatnonzero(np.isin(head, head[cols]))
        assert 0 <= k_lo and k_lo * TCW32_CHUNK <= ch.min() and ch.max() < k_hi * TCW32_CHUNK <= tcw_padded(c)
        assert (k_hi - k_lo) % 2 == 0
        plain = tcw_head_chunks(nb, c, hd, TCW32_CHUNK, block)
        assert (k_hi - k_lo) - (plain[3] - plain[2]) in (0, 1)  # widened by one chunk at most


@pytest.mark.parametrize("c,nhead,n,s", [(64, 8, 4, 4096), (64, 8, 4, 700), (96, 8, 2, 1100), (512, 8, 4, 4096),
                                         (2048, 16, 4, 4096), (640, 8, 2, 97), (32, 32, 1, 65)])
@pytest.mark.parametrize("chunk", [TCW_TILE, TCW32_CHUNK])
def test_tcw_source_groups_fill_the_card(c, nhead, n, s, chunk):
    """The stats' source groups: at most 16 (bf16) / 32 (split TF32) chunks and
    an even count (the split-TF32 loop takes chunks in pairs, and the last
    group's count stays even); smaller only where the widest groups give
    fewer than half the SMs a stats block, and then the least even count
    that needs no more groups than give every SM one."""
    hd, ck = c // nhead, tcw_padded(c) // TCW_TILE
    widest = max(hi - lo + 1 for lo, hi in (tcw_value_blocks(i, c, hd) for i in range(ck)))
    sc = -(-s // TCW_TILE) * (TCW_TILE // chunk)
    most = TCW32_SOURCE_GROUP if chunk == TCW32_CHUNK else TCW_SOURCE_GROUP
    sg = tcw_source_chunks(c, nhead, n, s, chunk)
    groups = -(-sc // sg)
    assert 2 <= sg <= most and sg % 2 == 0 and (sc - (groups - 1) * sg) % (2 if chunk == TCW32_CHUNK else 1) == 0
    blocks = widest * ck * n
    want = -(-TCW_FILL // blocks)  # groups that give every SM a block
    if 2 * blocks * -(-sc // most) >= TCW_FILL:
        assert sg == most
    else:
        assert sg - 2 < -(-sc // want) <= sg


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


def tcw_layer_by_the_plan(x, source, w, x_mask, source_mask, nhead, dtype, tf32=False):
    """The layer in the chains' order of sums, with product operands rounded to
    ``dtype`` as the kernels round them (f32 arithmetic): the attention over
    each block's k chunks of C padded to 64 channels (zeros past C), its
    denominators from 16 rows of head sums over 128-column blocks, or, at head
    widths that are not a multiple of 8, from replicated sums over 64-column
    blocks; with ``tf32``, the split-TF32 chain's: f32 operands, every product
    split (:func:`tf32x3_matmul`, the stats' ones row too), the attention over
    :func:`tcw32_head_chunks`' 32-channel chunks."""
    wq, wk, wv, wm, ln1s, ln1b, w0, w1, ln2s, ln2b = w  # [in, out]
    n, l, c = x.shape
    s, hd = source.shape[1], c // nhead
    mm = tf32x3_matmul if tf32 else torch.matmul
    chunk = TCW32_CHUNK if tf32 else TCW_TILE
    cp = tcw_padded(c)

    def r(t):
        return t.to(dtype).float()

    xb, sb = r(x), r(source)
    k = _elu_p1(mm(sb, r(wk)))
    if source_mask is not None:
        k = k * source_mask[..., None]
    kp, v = r(k), r(mm(sb, r(wv)))
    head = torch.arange(c) // hd
    # stats: each group's partials of the same-head blocks of K'^T V and sum K',
    # over the value blocks of each 64-channel tile only; groups summed in order
    group_rows = tcw_source_chunks(c, nhead, n, s, chunk) * chunk
    total = None
    for g0 in range(0, s, group_rows):
        kg, vg = kp[:, g0:g0 + group_rows], v[:, g0:g0 + group_rows]
        part = torch.zeros(n, c, hd + 1)
        for i in range(cp // TCW_TILE):
            lo, hi = tcw_value_blocks(i, c, hd)
            d = torch.arange(TCW_TILE * i, min(c, TCW_TILE * (i + 1)))
            e = torch.arange(lo * TCW_BLOCK, min(c, (hi + 1) * TCW_BLOCK))
            kt = kg[:, :, d].transpose(1, 2)
            prod = mm(kt, vg[:, :, e])  # [n, 64, E]
            for a, dd in enumerate(d.tolist()):
                same = head[e] == head[dd]
                part[:, dd, e[same] - head[dd] * hd] = prod[:, a, same]
            part[:, d, hd] = mm(kt, torch.ones(n, kt.shape[2], 1))[..., 0]  # the ones row
        total = part if total is None else total + part
    kvr = F.pad(r(total), (0, 0, 0, cp - c))  # the attention's B image: channels past C zero
    head = torch.arange(cp) // hd  # channels past C in heads of their own
    bd = torch.zeros(n, cp, c)  # block-diagonal KV, [channel d, value column e]
    for h in range(nhead):
        sl = slice(h * hd, (h + 1) * hd)
        bd[:, sl, sl] = kvr[:, sl, :hd]
    q = _elu_p1(mm(xb, r(wq)))
    if x_mask is not None:
        q = q * x_mask[..., None]
    qp = F.pad(r(q), (0, cp - c))  # Q' image: channels past C zero
    msg = torch.empty(n, l, c)
    rep = tcw_replicated(hd)
    block = TCW_REP_BLOCK if rep else TCW_BLOCK
    for nb in range(-(-c // block)):
        h_first, h_last, k_lo, k_hi = (tcw32_head_chunks(nb, c, hd, block) if tf32
                                       else tcw_head_chunks(nb, c, hd, block=block))
        cols = torch.arange(nb * block, min(c, (nb + 1) * block))
        ks = torch.arange(k_lo * chunk, k_hi * chunk)
        num = mm(qp[:, :, ks], bd[:, ks][:, :, cols])
        if rep:  # B row 64 + j: sum K' on the channels of column j's head
            reps = kvr[:, ks, hd, None] * (head[ks][:, None] == head[cols][None, :])
            inv = 1.0 / (mm(qp[:, :, ks], reps) + 1e-6)
        else:  # the rows of sum K'_h of the block's heads
            sums = torch.zeros(n, len(ks), TCW_SUMS)
            for i, h in enumerate(range(h_first, h_last + 1)):
                sums[:, :, i] = kvr[:, ks, hd] * (head[ks] == h)
            inv = 1.0 / (mm(qp[:, :, ks], sums)[..., head[cols] - h_first] + 1e-6)
        msg[:, :, cols] = r(num * inv)
    h1 = _layernorm_by_blocks(mm(msg, r(wm)), ln1s, ln1b)
    hid = r(torch.relu(mm(torch.cat([xb, r(h1)], dim=-1), r(w0))))
    return x + _layernorm_by_blocks(mm(hid, r(w1)), ln2s, ln2b)


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


@pytest.mark.parametrize("c,nhead", [(256, 4), (640, 8), (128, 16), (64, 8), (96, 12), (32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tcw_order_of_sums_reproduces_the_plain_version(c, nhead, dtype):
    """Ragged L, two source groups (S = 1100 rows: 18 chunks of 64, groups of
    16), masks; 16 heads a 128-column attention block at (128, 16), C padded
    to 64 channels at 96, replicated denominators at head widths 12 and 4.
    With f32 operands the plan only reorders f32 sums (1e-4); with bf16
    operands a rounded operand may land on the neighbouring bf16 value, so the
    kernels' tolerances hold (max 5e-2, mean 5e-3)."""
    x, src, w, (xm, sm) = _layer_inputs(c, 2, 97, 1100, seed=c)
    got = tcw_layer_by_the_plan(x, src, w, xm, sm, nhead, dtype)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=dtype)
    d = (got - ref).abs()
    if dtype == torch.float32:
        assert d.max().item() < 1e-4, d.max().item()
    else:
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3, (d.max().item(), d.mean().item())


@pytest.mark.parametrize("c,nhead", [(384, 16), (640, 8), (128, 16), (320, 40), (64, 8), (96, 12), (32, 8)])
def test_tcw32_order_of_sums_and_split_products_reproduce_the_plain_version(c, nhead):
    """The split-TF32 chain's plan (32-channel chunks, heads straddling them at
    head widths 24 and 80, 16 heads a block at head width 8, the attention's k
    range widened to an even count, C padded to 64 channels at 96, replicated
    denominators at head widths 12 and 4) with every product split into three
    TF32 products, at ragged L, two source groups (S = 1100 rows: 36 chunks of
    32, groups of 32) and masks: within 1e-4 of the plain f32 version (one TF32
    product in place of the three is off by ~3e-3 here)."""
    x, src, w, (xm, sm) = _layer_inputs(c, 2, 97, 1100, seed=c + 1)
    got = tcw_layer_by_the_plan(x, src, w, xm, sm, nhead, torch.float32, tf32=True)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float32)
    d = (got - ref).abs().max().item()
    assert d < 1e-4, d


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
