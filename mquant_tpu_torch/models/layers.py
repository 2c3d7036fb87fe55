"""Functional model layers + the quantized-linear dispatch (counterpart of
``mquant_tpu/models/layers.py``).

Each linear *site* is a plain function of (x, params dict, SiteSpec, state,
mode). Ported modes: "fp" (float weights ``w``), "fake" (float weights,
activations fake-quantized: quantize → dequantize in x's dtype, static
scales from ``state`` or dynamic per-token ones) and "real" (integer storage
``w_q``/``w_scale``, int8 activations, hand-written int GEMM kernels; a
site without ``w_q``, such as the ViT of an artifact whose LLM alone was
realized, takes the fake path, as in the JAX package) and "calib" (the fake
path, recording each static site's input into a :class:`Tape`; a static
site without calibrated scales passes x through). Output quantizers raise.

Forward order inside a site: online Hadamard → RMS split (channel 0 stays
fp, ``w_col0``) → activation quantize → GEMM → f32 col0 correction → bias.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import torch

from ..core.formats import get_format
from ..core.quant import dynamic_fake_quant, fake_quantize
from ..kernels.fwht import online_hadamard
from ..observe import observers as O


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static quantization config of one linear site (field parity with the
    JAX ``SiteSpec``)."""

    w_bits: Optional[int] = None
    a_bits: Optional[int] = None
    a_static: bool = False
    a_symmetric: bool = True
    a_per_channel: bool = False
    a_per_token: bool = True
    a_groupsize: Optional[int] = None
    a_clip_ratio: float = 1.0
    observer: str = "minmax"
    online_had: Optional[str] = None  # None | "full" | "head" | "block"
    head_dim: int = 0  # block width for online_had == "head" / "block"
    split: bool = False
    out_bits: Optional[int] = None

    def observer_spec(self) -> O.ObserverSpec:
        return O.ObserverSpec(kind=self.observer,
                              per_channel=self.a_per_channel,
                              symmetric=self.a_symmetric)


class Tape:
    """Collects per-site activation stats during a calibration forward:
    ``stats[name]`` folds each recorded input into the site's fresh
    ObserverStats; ``samples`` keeps the raw inputs (…, C) flattened to
    (N, C) when ``collect_samples``. ``mask`` (the leading axes of the
    recorded inputs, 1 = a valid token), where set, keeps the padded
    tokens of a padded patch sequence out of the stats; the samples keep
    every row, padded ones too, as the JAX Tape's do. The JAX Tape's
    ``prev`` stats have no caller here."""

    def __init__(self, collect_samples: bool = False):
        self.stats: Dict[str, O.ObserverStats] = {}
        self.samples: Dict[str, torch.Tensor] = {}
        self.collect_samples = collect_samples
        self.mask: Optional[torch.Tensor] = None

    def record(self, name: str, x: torch.Tensor, spec: SiteSpec):
        ospec = spec.observer_spec()
        st = O.init_stats(ospec, x.shape[-1] if ospec.per_channel else None,
                          device=x.device)
        self.stats[name] = O.update(ospec, st, x, mask=self.mask)
        if self.collect_samples:
            self.samples[name] = x.reshape(-1, x.shape[-1])


def stack_tapes(tapes: list) -> Optional[tuple]:
    """Per-layer tapes → (stats, samples) stacked along a leading (L,)
    axis, the JAX layer scan's output (None for no tapes)."""
    if not tapes:
        return None
    stats = {k: O.ObserverStats(*(torch.stack([t.stats[k][i] for t in tapes])
                                  for i in range(3)))
             for k in tapes[0].stats}
    samples = {k: torch.stack([t.samples[k] for t in tapes])
               for k in tapes[0].samples}
    return stats, samples


def _online_hadamard(x: torch.Tensor, spec: SiteSpec) -> torch.Tensor:
    """Runtime Hadamard on the activation before quantization: "full" over
    the whole feature dim, "head"/"block" over fixed-width blocks
    (I_{n/b} ⊗ H_b)."""
    if spec.online_had == "full":
        return online_hadamard(x)
    if spec.online_had not in ("head", "block") or spec.head_dim <= 0:
        raise ValueError(f"bad online_had {spec.online_had!r} / head_dim "
                         f"{spec.head_dim}")
    *lead, n = x.shape
    xr = x.reshape(*lead, n // spec.head_dim, spec.head_dim)
    return online_hadamard(xr).reshape(*lead, n)


def _check_servable(p: Dict[str, Any], spec: SiteSpec, mode: str):
    if mode not in ("real", "fake", "calib"):
        raise ValueError(f"unknown mode {mode!r} (fp, calib, fake or real)")
    if "w_col0" in p and not spec.split and "w" not in p:
        # the JAX function rejoins w_col0 to a float ``w``, which integer
        # storage no longer has (it fails there on the missing key)
        raise NotImplementedError("split integer storage needs spec.split: "
                                  "the fp column cannot rejoin int codes")


def _quantize_act(x: torch.Tensor, spec: SiteSpec, site_state,
                  mesh=None) -> torch.Tensor:
    """The fake and calib paths' activation quantizer: the site's static
    QuantParams (x unchanged while the site has none: calibration not
    finalized yet), else dynamic scales; with ``mesh`` x is a row-parallel
    rank's columns, and the scales are the whole row's
    (:func:`_tp_act_qparams`)."""
    fmt = get_format(spec.a_bits, signed=spec.a_symmetric)
    if spec.a_static:
        if site_state is None or site_state.get("act") is None:
            return x
        return fake_quantize(x, site_state["act"], fmt)
    if mesh is not None:
        return fake_quantize(x, _tp_act_qparams(x, spec, mesh), fmt)
    return dynamic_fake_quant(x, bits=spec.a_bits, per_token=spec.a_per_token,
                              symmetric=spec.a_symmetric,
                              clip_ratio=spec.a_clip_ratio,
                              groupsize=spec.a_groupsize)


def per_step(fn, x: torch.Tensor, verify: bool = False) -> torch.Tensor:
    """fn(x) for x (B, T, ...). With ``verify`` (x a speculative verify
    window, ``models.llm.decoder_forward``), fn of each step's rows
    x[:, j:j+1] apart, concatenated along T: fn then meets the (B, 1, ...)
    rows of the decode step that makes window row j, so a product or a row
    reduction whose rounding depends on its row count (cuBLAS picks its
    kernel by M, a reduction its split by the number of rows) gives row j
    that step's bits."""
    if not verify or x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, j:j + 1].contiguous())
                      for j in range(x.shape[1])], dim=1)


def qlinear(x: torch.Tensor, p: Dict[str, Any], name: str,
            spec: Optional[SiteSpec] = None,
            state: Optional[Dict[str, Any]] = None,
            mode: str = "fp", tape: Optional[Tape] = None,
            verify: bool = False) -> torch.Tensor:
    """y = x @ w + b through the site's transform / quant pipeline, or this
    rank's part of it under a tensor-parallel mesh (``parallel.sharding``):
    a row-parallel site reduces across the tp row (:func:`_qlinear`),
    a column-parallel site runs on its columns and the sites of
    ``sharding.GATHERED_SITES`` gather their output (calibration, and the
    group-blocked epilogue of path A, raise under a mesh)."""
    from ..parallel import sharding as PS

    mesh = PS.tp_mesh()
    if mesh is None:
        return _qlinear(x, p, name, spec, state, mode, tape, verify)
    if mode == "calib" or tape is not None:
        PS.refuse_under_mesh("calibration", "A14c")
    _refuse_path_a([p], [spec], mode)
    kind = PS.site_kind(name)
    if kind == "row":
        return _qlinear(x, p, name, spec, state, mode, None, verify, mesh)
    y = _qlinear(x, p, name, spec, state, mode, tape, verify)
    if kind == "col" and name in PS.GATHERED_SITES:
        from ..parallel import collectives as PC

        y = PC.gather_last(y, mesh)
    return y


def _qlinear(x: torch.Tensor, p: Dict[str, Any], name: str,
             spec: Optional[SiteSpec] = None,
             state: Optional[Dict[str, Any]] = None,
             mode: str = "fp", tape: Optional[Tape] = None,
             verify: bool = False, row=None) -> torch.Tensor:
    """y = x @ w + b on one rank's whole site, or with ``row`` (a mesh)
    this rank's part of a row-parallel site. Split
    storage (``w_col0`` (…, 1, out) and ``w`` / ``w_q`` over input rows
    1..n−1): with ``spec.split`` channel 0 of the (rotated) input skips the
    quantizer and adds (x0 · w_col0) in f32 after the GEMM; otherwise (fp
    mode, or a spec without the split) the column rejoins a float ``w``.
    ``tape`` records a static site's input as the quantizer sees it (after
    the Hadamard and the split). ``verify``: x (B, T, in) is a speculative
    verify window; the float products (the weight's, the online Hadamard's,
    the split column's) run on each step's rows apart (:func:`per_step`),
    the integer product on the whole window (exact). With ``spec.out_bits``
    the output is fake-quantized by the site's static ``"out"`` params (or,
    calibrating, recorded as the ``name#out`` site).

    A row-parallel site holds its input columns x (…, K / tp) and weight
    rows (``sharding.row_bounds``) and reduces across the tp row: in real
    mode the kernels' int32 accumulators (:func:`_row_int_matmul`), exact,
    bit-equal to the single rank; in fp and fake mode the float partial
    products summed in f32, as GSPMD reduces them. Dynamic activation
    scales take the whole row's min / max (:func:`_tp_act_qparams`). The
    full online Hadamard mixes every channel, and an act_order ``a_perm``
    indexes the whole input: those sites gather x first, rotate and
    quantize it whole, and take their rows' columns. A block or head
    Hadamard is local (its block divides the local width). The RMS split's
    channel 0 and a rejoined ``w_col0`` lie on rank 0: every rank takes x0
    from the gather, or from rank 0's broadcast, and adds x0 · w_col0 once,
    after the reduce."""
    from ..kernels.qmm import quantized_matmul
    from ..parallel import collectives as PC

    rank0 = row is None or row.tp_index == 0
    if spec is None or mode == "fp":
        w = p["w"]
        if "w_col0" in p and rank0:  # split storage in fp mode: recombine
            w = torch.cat([p["w_col0"], w], dim=-2)
        w = w.to(x.dtype)
        y = per_step(lambda t: t @ w, x, verify)
        if row is not None:
            y = PC.all_reduce_f32(y, row)
        return y + p["b"].to(y.dtype) if p.get("b") is not None else y
    _check_servable(p, spec, mode)
    whole = row is not None and (spec.online_had == "full"
                                 or p.get("a_perm") is not None)
    if whole:
        from ..parallel.sharding import row_bounds

        x = PC.gather_last(x.contiguous(), row)
        cols = row_bounds(x.shape[-1], row.tp, row.tp_index,
                          "w_col0" in p and spec.split)
    if spec.online_had is not None:
        if row is not None and not whole and x.shape[-1] % spec.head_dim:
            raise ValueError(f"{name}: the local width {x.shape[-1]} is no "
                             f"multiple of the Hadamard block "
                             f"{spec.head_dim}")
        x = per_step(lambda t: _online_hadamard(t, spec), x, verify)
    x0 = None
    if "w_col0" in p and spec.split:  # RMS split: channel 0 stays fp
        if row is None or whole or rank0:
            x0, x = x[..., :1], x[..., 1:]
        if row is not None and not whole:
            if not rank0:
                x0 = x.new_empty((*x.shape[:-1], 1))
            x0 = PC.broadcast(x0.contiguous(), row)
    elif "w_col0" in p:  # split storage, spec without the split: rejoin
        p = {**p, "w": (torch.cat([p["w_col0"], p["w"]], dim=-2) if rank0
                        else p["w"])}
    if tape is not None and spec.a_bits is not None and spec.a_static:
        tape.record(name, x, spec)
    site_state = None if state is None else state.get(name)
    local = None if whole else row  # a row's mesh where x is its columns
    act = None if site_state is None else site_state.get("act")
    if local is not None and spec.a_static and act is not None and \
            torch.as_tensor(act.scale).numel() > 1:
        from ..parallel.sharding import refuse_under_mesh

        # the calibrated state holds the whole row's channel scales
        refuse_under_mesh("per-channel static activation scales at a "
                          "row-parallel site", "A14b")
    if mode == "real" and "w_q" in p:
        if row is None:
            y = quantized_matmul(x, p, spec, site_state)
        else:
            y = _row_int_matmul(x, p, spec, site_state, row, local,
                                cols if whole else None)
    else:
        if "w" not in p:
            raise ValueError(f"{name}: mode {mode!r} needs float weights "
                             "'w' (integer storage is served in real mode)")
        xq = x if spec.a_bits is None else _quantize_act(x, spec, site_state,
                                                         local)
        if whole:
            xq = xq[..., cols[0]:cols[1]]
        w = p["w"].to(xq.dtype)
        y = per_step(lambda t: t @ w, xq, verify)
        if row is not None:
            y = PC.all_reduce_f32(y, row)
    if x0 is not None:
        c0 = p["w_col0"].float()
        y = y + per_step(lambda t: t.float() @ c0, x0, verify).to(y.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    if spec.out_bits is not None and site_state is not None \
            and site_state.get("out") is not None:
        y = fake_quantize(y, site_state["out"],
                          get_format(spec.out_bits, signed=spec.a_symmetric))
    elif tape is not None and spec.out_bits is not None:
        tape.record(name + "#out", y, spec)
    return y


def _refuse_path_a(ps: list, specs: list, mode: str) -> None:
    """Raise under a tensor-parallel mesh for a real-mode site on the
    group-blocked epilogue (path A's storage)."""
    from ..kernels.qmm import grouped_route
    from ..parallel.sharding import refuse_under_mesh, tp_mesh

    if mode == "real" and tp_mesh() is not None and any(
            s is not None and "w_q" in p and grouped_route(p, s)
            for p, s in zip(ps, specs)):
        refuse_under_mesh("grouped storage (path A)", "A14b")


def _tp_act_qparams(x: torch.Tensor, spec: SiteSpec, mesh):
    """Dynamic activation params of a row-parallel site's local columns as
    the whole row gives them (``core.quant.dynamic_qparams``): the local
    min / max per token (or per tensor) maximized across the tp row, one
    ``all_reduce(MAX)``, before the scale is formed."""
    from ..core.quant import scales_from_minmax
    from ..parallel import collectives as PC

    if spec.a_groupsize:
        from ..parallel.sharding import refuse_under_mesh

        refuse_under_mesh("per-group activation scales", "A14b")
    xf = x.float()
    if spec.a_per_token:
        mn, mx = xf.amin(-1, keepdim=True), xf.amax(-1, keepdim=True)
    else:
        mn, mx = xf.min(), xf.max()
    both = PC.all_reduce(torch.stack([mx, -mn]), mesh, "max")
    fmt = get_format(spec.a_bits, signed=spec.a_symmetric)
    return scales_from_minmax(-both[1] * spec.a_clip_ratio,
                              both[0] * spec.a_clip_ratio, fmt,
                              spec.a_symmetric)


def _row_int_matmul(x: torch.Tensor, p: Dict[str, Any], spec: SiteSpec,
                    site_state, mesh, local, cols) -> torch.Tensor:
    """The real-mode product of a row-parallel site: the activation
    quantized with the site's scale (static: elementwise; dynamic on local
    columns: :func:`_tp_act_qparams`), the kernels' int32 accumulators
    (``out_dtype=torch.int32``) over this rank's rows (``cols`` of a
    gathered x), one ``all_reduce(SUM)`` of them (exact), then the dequant
    epilogue once (``kernels.qmm.dequant_acc``, the fused epilogue's
    rounding) and ``a_corr``: bit-equal to the single rank."""
    from ..core.formats import INT8
    from ..core.quant import quantize
    from ..kernels import qmm
    from ..parallel import collectives as PC

    if spec.a_bits is not None and not spec.a_static and local is not None:
        qp = _tp_act_qparams(x, spec, local)
        aq = qmm.ActQ(quantize(x, qp, INT8, qmm._codes_out(x)), qp.scale,
                      qp.zero_point)
    else:
        aq = qmm._act_int8(x, spec, site_state, p)
    q = aq.q
    ap = p.get("a_perm")
    if ap is not None:
        q = q.index_select(-1, ap.to(device=q.device, dtype=torch.long))
    if cols is not None:
        q = q[..., cols[0]:cols[1]]
    pl = {k: v for k, v in p.items() if k in ("w_q", "w_scale")}
    acc = qmm.quantized_matmul_pre(q, aq.scale, pl, torch.int32,
                                   x_zp=aq.zp, a_groupsize=aq.groupsize)
    PC.all_reduce(acc, mesh)
    y = qmm.dequant_acc(acc, aq.scale, p["w_scale"], x.dtype)
    return y + p["a_corr"].to(y.dtype) if "a_corr" in p else y


def qlinear_group(x: torch.Tensor, ps: list, names: list,
                  specs: Dict[str, Optional[SiteSpec]],
                  state: Optional[Dict[str, Any]] = None,
                  mode: str = "fp", tape: Optional[Tape] = None,
                  verify: bool = False) -> list:
    """Several sites sharing ONE input (q/k/v, gate/up). On the real-int path
    the input is quantized once for the group (exact: the sites' static
    scales and dynamic per-token scales see the identical tensor); sites
    fused by ``pack_w4_sites`` run as ONE GEMM whose output is sliced apart
    by each member's ``w_scale`` width. ``verify`` as in :func:`qlinear`."""
    from ..kernels.qmm import _act_int8, quantized_matmul_pre

    sp = [specs.get(n) for n in names]
    _refuse_path_a(ps, sp, mode)
    s0 = sp[0]
    base_ok = (mode == "real" and s0 is not None
               and all(s == s0 for s in sp) and s0.a_bits == 8
               and s0.online_had is None and not s0.split
               and s0.out_bits is None)
    fused0 = ps[0].get("w_q_fused")
    one_gemm = (base_ok and fused0 is not None
                and all(p.get("w_q_fused") is not None for p in ps)
                and sum(p["w_scale"].shape[-1] for p in ps) == fused0.shape[-1])
    fusable = base_ok and all("w_q" in p and "w_col0" not in p for p in ps)
    if not (one_gemm or fusable):
        return [qlinear(x, p, n, specs.get(n), state, mode, tape, verify)
                for p, n in zip(ps, names)]

    site_state = None if state is None else state.get(names[0])
    aq = _act_int8(x, s0, site_state, ps[0])
    if one_gemm:
        pf = {"w_q": fused0, "w_scale": ps[0]["w_scale_fused"]}
        y = quantized_matmul_pre(aq.q, aq.scale, pf, x.dtype, x_zp=aq.zp,
                                 a_groupsize=aq.groupsize)
        outs = []
        lo = 0
        for p in ps:
            hi = lo + p["w_scale"].shape[-1]
            yi = y[..., lo:hi]
            if "a_corr" in p:
                yi = yi + p["a_corr"].to(yi.dtype)
            if p.get("b") is not None:
                yi = yi + p["b"].to(yi.dtype)
            outs.append(yi)
            lo = hi
        return outs
    outs = []
    for p in ps:
        y = quantized_matmul_pre(aq.q, aq.scale, p, x.dtype, x_zp=aq.zp,
                                 a_groupsize=aq.groupsize)
        if "a_corr" in p:
            y = y + p["a_corr"].to(y.dtype)
        if p.get("b") is not None:
            y = y + p["b"].to(y.dtype)
        outs.append(y)
    return outs


# ---------------------------------------------------------------------------
# random initialization
# ---------------------------------------------------------------------------


_DRAW_CHUNK = 1 << 24  # values a generator draws at a time in normal_init


def normal_init(gen: torch.Generator, shape, scale: Optional[float] = None,
                dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """N(0, 1) · ``scale`` (default 1/√fan_in, fan_in = shape[-2]) drawn in
    f32 and rounded to ``dtype`` on ``device``: the JAX package's
    ``init_*_params`` draw. The rows (all axes but the last, flattened) go
    in chunks of about 2²⁴ values, each from its own generator on ``gen``'s
    device seeded by one draw from ``gen``, so the values depend on ``gen``
    and ``shape`` only: a CPU generator gives the same values whichever
    device they end on. On the CPU the chunks are drawn by a thread pool
    (the weights of a 7B model in seconds, not minutes)."""
    scale = scale if scale is not None else 1.0 / shape[-2] ** 0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _DRAW_CHUNK // shape[-1])
    starts = range(0, rows.shape[0], step)
    seeds = torch.randint(0, 2**62, (len(starts),), generator=gen,
                          device=gen.device).tolist()

    def draw(i: int) -> torch.Tensor:
        n = min(step, rows.shape[0] - starts[i])
        child = torch.Generator(device=gen.device).manual_seed(seeds[i])
        w = torch.randn((n, shape[-1]), generator=child, device=gen.device)
        return (w * scale).to(dtype)

    if gen.device.type != "cpu":
        for i, r in enumerate(starts):
            rows[r:r + step].copy_(draw(i))
        return out
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for i, part in enumerate(pool.map(draw, range(len(starts)))):
            rows[starts[i]:starts[i] + step].copy_(part)
    return out


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with f32 statistics."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0, dtype=torch.float32):
    """RoPE cos/sin tables for integer positions (..., T)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """Rotate-half RoPE; q/k (..., T, H, hd), cos/sin (..., T, hd)."""

    def rot(v):
        v1, v2 = v.chunk(2, dim=-1)
        return torch.cat([-v2, v1], dim=-1)

    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return ((q * c + rot(q) * s).to(q.dtype),
            (k * c + rot(k) * s).to(k.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(−x)), each op rounded to x's dtype: the expansion XLA
    gives ``jax.nn.sigmoid`` on the CPU, so bf16 activations round where
    the JAX package's do (one f32 sigmoid rounded once differs from it in
    about a third of bf16 values)."""
    return 1 / (1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU as ``jax.nn.gelu(x, approximate=False)`` computes it:
    (0.5 · x) · erfc(−x · √½), each op rounded to x's dtype (√½ too), so
    bf16 activations round where the JAX package's do (torch's GELU rounds
    once and differs from it in about a third of bf16 values)."""
    # √½ rounded to x's dtype, as a host scalar (no copy in a graph capture)
    sqrt_half = float(torch.tensor(0.5 ** 0.5).to(x.dtype))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU as ``jax.nn.gelu(x, approximate=True)`` computes it:
    x · (0.5 · (1 + tanh(√(2/π) · (x + 0.044715 · x³)))), each op
    rounded to x's dtype (√(2/π) and 0.044715 too)."""
    c, k = (float(torch.tensor(v).to(x.dtype))
            for v in ((2 / math.pi) ** 0.5, 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) · up as ``jax.nn.silu(gate) * up``: (gate · sigmoid(gate))
    · up, each product rounded to the inputs' dtype."""
    return gate * sigmoid(gate) * up


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


# causal prefills at least this long take the flash kernel (the JAX
# package's MQUANT_FLASH_MIN_T default; the port has no knob for it)
FLASH_MIN_T = 2048


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card, where the kernels' contracts bind (on
    the CPU every plain version takes everything). The routers of this
    module and of ``models.llm`` ask it."""
    return t.device.type == "cuda"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None, causal: bool = False
              ) -> torch.Tensor:
    """Grouped-query attention: q (B, T, H, hd), k/v (B, S, KVH, hd), bool
    mask (B, 1, T, S) (True = attend) or ``causal``. A long causal prefill
    (no mask, T == S ≥ ``FLASH_MIN_T``, hd % 128 == 0, T % 128 == 0) goes to
    ``kernels.flash_attn`` (the CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor), as the JAX function routes to Pallas flash
    attention; on the card only inside the kernel's contract
    (``flash_attn.supports``). Everything else is :func:`einsum_attention`."""
    from ..kernels import flash_attn

    B, T, H, hd = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else hd**-0.5
    if (causal and mask is None and T == S and T >= FLASH_MIN_T
            and hd % 128 == 0 and T % 128 == 0
            and (not _on_card(q) or flash_attn.supports(hd, q.dtype, T))):
        return flash_attn.KERNELS["flash_attn_causal"](
            q.contiguous(), k.contiguous(), v.contiguous(), scale)
    return einsum_attention(q, k, v, mask, scale, causal)


def causal_mask(T: int, S: int, offset: int = 0, device="cuda"
                ) -> torch.Tensor:
    """Boolean (1, 1, T, S) causal mask (True = attend); ``offset`` = number
    of cached tokens. On the card unless ``device`` says otherwise."""
    rows = torch.arange(T, device=device)[:, None] + offset
    cols = torch.arange(S, device=device)[None, :]
    return (cols <= rows)[None, None]


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], scale: float,
                     causal: bool = False) -> torch.Tensor:
    """The GQA einsum: logits and softmax in f32 (the JAX einsum's
    preferred_element_type); probabilities cast back to q's dtype for the
    P·V product. Masked logits are −1e30."""
    B, T, H, hd = q.shape
    KVH, S = k.shape[2], k.shape[1]
    G = H // KVH
    qg = q.reshape(B, T, KVH, G, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask[:, :, None] if mask.ndim == 4 else mask  # (B, 1, 1, T, S)
        logits = logits.masked_fill(~m, -1e30)
    if causal and mask is None:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(q.dtype))
    return out.reshape(B, T, H, hd)
