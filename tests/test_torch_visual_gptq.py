"""Visual GPTQ (``gptq/driver.py::gptq_quantize_vit``, ``gptq/modules.py``,
the pipeline's visual branch) and the decoder driver's host streaming in
the port, against the JAX package's on the same numpy-drawn inputs at
tiny widths (f32, CPU).

* The first block's sites, each fed JAX's Hessian of its stage: codes
  bit-equal to JAX's ``gptq_quantize_matrix`` (with and without
  act_order).
* The whole patch embed, tower and merger through ``quantize_weights``
  (act_order, as the card runs it): ≥ 99.5% of each site's codes equal to
  JAX's, each site's proxy loss tr(ΔWᵀ H ΔW) on its own Hessian within 1%
  of JAX's, no RTN fallback; the sites left to RTN (none here) and the LLM
  untouched.
* ``stream_from_host``: the decoder's weights on the host, a layer at a
  time to the device, give weights bit-equal to the resident run, returned
  on the host; with ``realize_on_device`` the integer codes equal
  ``realize_decoder_weights`` on the resident run's grids (act_order ×
  group_size's permuted rows and ``a_perm`` too), as
  ``tests/test_gptq_driver.py`` holds JAX. (The resident port driver is
  held against JAX's in ``tests/test_torch_gptq.py``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.gptq import core as JG
from mquant_tpu.gptq import driver as JD
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.transform import recipes as JR
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.gptq import core as TG
from mquant_tpu_torch.gptq import driver as TD
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
from mquant_tpu_torch.transform.recipes import realize_decoder_weights

VIS = ("vis.q", "vis.k", "vis.v", "vis.o", "vis.fc1", "vis.fc2",
       "vis.patch_embed", "merger.mlp0", "merger.mlp2")


@pytest.fixture(scope="module")
def tower():
    fam = j_family("qwen2vl")
    jc, tc = fam.tiny_fn(), Qwen2VLConfig.tiny()
    pj = fam.init_fn(jc, jax.random.key(0))
    jb = JP.synthetic_calib_batches(fam, jc, 3, jax.random.key(5))
    sj = {k: v for k, v in JP.build_specs(fam, JP.QuantizeConfig()).items()
          if k in VIS}
    st = {k: v for k, v in TP.build_specs(TP.QuantizeConfig()).items()
          if k in VIS}
    return dict(fam=fam, jc=jc, tc=tc, pj=pj,
                pt=interop.to_torch(pj, device="cpu"), jb=jb,
                tb=[interop.to_torch(b, device="cpu") for b in jb], sj=sj,
                st=st)


def _codes(w, scale):
    return np.round(np.asarray(w, np.float64) / np.asarray(scale, np.float64))


@pytest.mark.parametrize("act_order", [False, True])
def test_first_block_given_jax_hessian(tower, act_order):
    from mquant_tpu.models.vision import rot2d_tables, vit_preamble

    d = tower
    cfg = d["jc"].vit
    bp = jax.tree.map(lambda x: x[0], d["pj"]["vit"]["blocks"])
    stage = {"q": "qkv", "k": "qkv", "v": "qkv", "o": "o", "fc1": "fc1",
             "fc2": "fc2"}
    fns = {s: JD.make_vit_stage_fn(cfg, d["sj"], s)
           for s in set(stage.values())}
    for site, sname in stage.items():
        H = None
        for b in d["jb"]:
            h = vit_preamble(cfg, d["pj"]["vit"], b["patches"])
            cos, sin = jax.vmap(lambda g: rot2d_tables(g, cfg.head_dim))(
                b["grid_hw"])
            H = JG.accumulate_hessian(H, fns[sname](bp, h, cos, sin))
        W = np.asarray(bp[site]["w"], np.float32)
        rj = JG.gptq_quantize_matrix(jnp.asarray(W), H, bits=8,
                                     act_order=act_order)
        rt = TG.gptq_quantize_matrix(torch.from_numpy(W.copy()),
                                     torch.from_numpy(np.array(H)), bits=8,
                                     act_order=act_order)
        assert not bool(rj.used_fallback) and not bool(rt.used_fallback)
        np.testing.assert_array_equal(rt.scale.numpy(), np.asarray(rj.scale))
        np.testing.assert_array_equal(_codes(rt.w.numpy(), rt.scale.numpy()),
                                      _codes(rj.w, rj.scale), err_msg=site)


def _recorder(module, log):
    saved = module.gptq_quantize_matrix

    def wrapped(W, H, *a, **kw):
        res = saved(W, H, *a, **kw)
        log.append((np.asarray(W, np.float64), np.asarray(H, np.float64),
                    np.asarray(res.w, np.float64)))
        return res

    return saved, wrapped


def _proxy(Wq, W, H):
    d = Wq - W
    return float(np.einsum("io,ij,jo->", d, H, d))


def test_tower_and_merger_match_jax(tower, monkeypatch):
    d = tower
    log_j, log_t = [], []
    monkeypatch.setattr(JG, "gptq_quantize_matrix",
                        _recorder(JG, log_j)[1])
    monkeypatch.setattr(TG, "gptq_quantize_matrix",
                        _recorder(TG, log_t)[1])
    qj = JP.QuantizeConfig(visual_w_rtn=False, act_order=True, nsamples=8)
    qt = TP.QuantizeConfig(visual_w_rtn=False, act_order=True, nsamples=8)
    pj, _ = JP.quantize_weights(d["fam"], d["jc"], d["pj"], d["sj"], qj,
                                d["jb"])
    rep = {}
    with torch.no_grad():
        pt, wq = TP.quantize_weights(d["tc"], d["pt"], d["st"], qt, d["tb"],
                                     vis_report=rep)
    assert wq is None and rep["fallbacks"] == [] and rep["sites"] == 15
    # the order the drivers run: patch embed, 2 blocks × 6, mlp0, mlp2
    assert len(log_t) == len(log_j) == 15
    np.testing.assert_array_equal(log_t[0][0], log_j[0][0])  # patch embed
    for i, ((Wj, Hj, Qj), (Wt, Ht, Qt)) in enumerate(zip(log_j, log_t)):
        pj_, pt_ = _proxy(Qj, Wj, Hj), _proxy(Qt, Wt, Ht)
        assert abs(pt_ - pj_) <= 0.01 * pj_, (i, pt_, pj_)
    agree = {}
    lj = d["pj"]
    for name, path in (("vis.patch_embed", ("vit", "patch_embed")),
                       ("merger.mlp0", ("merger", "mlp0")),
                       ("merger.mlp2", ("merger", "mlp2")),
                       *[(f"vis.{s}", ("vit", "blocks", s))
                         for s in ("q", "k", "v", "o", "fc1", "fc2")]):
        a, b, src = pj, pt, lj
        for k in path:
            a, b, src = a[k], b[k], src[k]
        wa, wb = np.asarray(a["w"]), b["w"].numpy()
        assert not np.array_equal(wa, np.asarray(src["w"])), name
        agree[name] = float((wa == wb).mean())
    low = {k: v for k, v in agree.items() if v < 0.995}
    assert not low, f"code agreement {agree}"
    assert pt["llm"] is d["pt"]["llm"]


# --- the decoder driver's host streaming --------------------------------------


def _decoder(split: bool):
    cfg_j = JLLM.DecoderConfig(vocab=97, hidden=64, n_layers=2, n_heads=4,
                               n_kv_heads=2, intermediate=128,
                               dtype=jnp.float32)
    d = {f.name: getattr(cfg_j, f.name)
         for f in dataclasses.fields(TLLM.DecoderConfig)}
    cfg_t = TLLM.DecoderConfig(**{**d, "dtype": torch.float32})
    params = JLLM.init_decoder_params(cfg_j, jax.random.key(0))
    fused = JR.fuse_decoder(cfg_j, params)
    rot, _ = JR.rotate_decoder(cfg_j, fused, jax.random.key(1),
                               online_had_down=True)
    pt = interop.to_torch(JR.split_decoder_down(rot) if split else rot,
                          device="cpu")
    embeds = [torch.from_numpy(np.asarray(params["embed"]["w"])[np.asarray(
        jax.random.randint(jax.random.key(10 + i), (2, 24), 0, 97))].copy())
        for i in range(2)]
    kw = dict(w_bits=4, a_bits=8, a_static=True)
    specs = {f"llm.{s}": TSpec(**kw) for s in TLLM.LLM_SITES}
    specs["llm.down"] = TSpec(**kw, online_had="full", split=split)
    return cfg_t, pt, embeds, specs


GCFGS = {"plain": {}, "act_order": dict(act_order=True),
         "grouped": dict(act_order=True, group_size=32)}


@pytest.mark.parametrize("kind", list(GCFGS))
def test_stream_from_host_matches_resident(kind):
    """The rotated tiny decoder, ``down`` RMS-split (not with 32-row
    groups: its 127 rows)."""
    cfg, pt, embeds, specs = _decoder(split=kind != "grouped")
    gcfg = TD.GPTQConfig(**GCFGS[kind])
    p_dev, rep = TD.gptq_quantize_decoder(cfg, pt, embeds, specs, gcfg=gcfg)
    p_host, _ = TD.gptq_quantize_decoder(cfg, pt, embeds, specs, gcfg=gcfg,
                                         stream_from_host=True)
    for site in TLLM.LLM_SITES:
        assert torch.equal(p_host["layers"][site]["w"],
                           p_dev["layers"][site]["w"]), site
        assert p_host["layers"][site]["w"].device.type == "cpu"
    if kind != "grouped":
        assert torch.equal(p_host["layers"]["down"]["w_col0"],
                           pt["layers"]["down"]["w_col0"])
    done = []
    p_rt, rep_rt = TD.gptq_quantize_decoder(
        cfg, pt, embeds, specs, gcfg=gcfg, stream_from_host=True,
        realize_on_device=True, progress=lambda i, n: done.append((i, n)))
    assert done == [(0, 2), (1, 2)]
    with pytest.raises(ValueError, match="stream_from_host"):
        TD.gptq_quantize_decoder(cfg, pt, embeds, specs, gcfg=gcfg,
                                 realize_on_device=True)
    ref = realize_decoder_weights(p_dev, specs, qps=rep["qparams"])
    for site in TLLM.LLM_SITES:
        got, want = p_rt["layers"][site], ref["layers"][site]
        assert "w" not in got
        assert torch.equal(got["w_q"], want["w_q"]), site
        assert torch.equal(got["w_scale"], want["w_scale"]), site
        if kind == "grouped":
            assert torch.equal(got["a_perm"], want["a_perm"]), site
    assert torch.equal(p_rt["layers"]["ln1"]["w"], pt["layers"]["ln1"]["w"])
    for s in rep["qparams"]:
        for a, b in zip(rep["qparams"][s], rep_rt["qparams"][s]):
            assert (a is None and b is None) or torch.equal(a, b)
