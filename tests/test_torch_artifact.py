"""Quantization artifacts of the JAX pipeline read and written by the port
(``mquant_tpu_torch.utils.checkpoint``).

The JAX ``run_pipeline("qwen2vl", tiny=True, artifact_dir=...)`` runs once
per module for three configurations: (a) realized int storage with the
default full online Hadamard and RMS split before ``down``; (b) the default
fake-quantized artifact; (c) realized, block Hadamard (which pads the
intermediate to 128, ``intermediate_pad``), an int8 lm_head and the visual
split with the online visual Hadamard on ``vis.fc2``. The port's
``load_artifact(device="cpu")`` must equal JAX's ``load_artifact``: leaves
bit-equal with the same dtypes, the same None slots, QuantParams, specs
field by field, and the config. The port's ``save_artifact`` must write the
same bytes, which JAX reads back.
"""

import dataclasses
import filecmp
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.pipeline import QuantizeConfig, build_specs, run_pipeline
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch.core.quant import QuantParams
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.serve.generate import Generator
from mquant_tpu_torch.utils import checkpoint as TC

# the three pipeline configurations (a), (b), (c)
ARTIFACT_CONFIGS = {
    "a_real_full": dict(realize_int=True),
    "b_fake": dict(realize_int=False),
    "c_real_block_head8_vissplit": dict(
        realize_int=True, online_had_mode="block", lm_head_bits=8,
        visual_split=True, online_visual_hadamard=True),
}
PIPELINE_SECONDS = {}  # name → seconds of its JAX pipeline run (printed)


def make_artifacts(tmp_path_factory) -> dict:
    """name → artifact directory, one JAX pipeline run each at the tiny
    Qwen2-VL (the test suite's calibration sizes)."""
    out = {}
    for name, kw in ARTIFACT_CONFIGS.items():
        art = str(tmp_path_factory.mktemp(name))
        q = QuantizeConfig(llm_w_bits=4, visual_w_bits=8, calib_num=16,
                           nsamples=8, **kw)
        t0 = time.perf_counter()
        run_pipeline("qwen2vl", q, tiny=True, artifact_dir=art)
        PIPELINE_SECONDS[name] = time.perf_counter() - t0
        out[name] = art
    print("pipeline seconds:", PIPELINE_SECONDS)
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return make_artifacts(tmp_path_factory)


def _equal(t, j, where=""):
    """Port tree ``t`` equals JAX tree ``j``: the same keys and None slots,
    QuantParams for QuantParams, leaves bit-equal with the same dtype."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), where
        for k in j:
            _equal(t[k], j[k], f"{where}/{k}")
    elif j is None:
        assert t is None, where
    elif isinstance(j, tuple):
        assert isinstance(t, QuantParams), where
        _equal(t.scale, j.scale, where + ".scale")
        _equal(t.zero_point, j.zero_point, where + ".zero_point")
    else:
        ref = np.asarray(j)
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == ref.shape, \
            where
        assert str(t.dtype).removeprefix("torch.") == ref.dtype.name, where
        if ref.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          ref.view(np.int16), err_msg=where)
        else:
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=where)


def _config_equal(t, j, where="cfg"):
    """A port config equals a JAX config field by field: the port's fields
    hold JAX's values (dtypes by name); JAX's extra fields are checked by
    the refusal tests."""
    assert type(t).__name__ == type(j).__name__, where
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _config_equal(tv, jv, f"{where}.{f.name}")
        elif isinstance(tv, torch.dtype):
            assert str(tv).removeprefix("torch.") == np.dtype(jv).name, where
        else:
            assert tv == jv, f"{where}.{f.name}: {tv!r} vs {jv!r}"


NAMES = list(ARTIFACT_CONFIGS)


@pytest.mark.parametrize("name", NAMES)
def test_load_equals_jax(artifacts, name):
    art = artifacts[name]
    pj, sj, spj, mj = JC.load_artifact(art)
    pt, st, spt, mt = TC.load_artifact(art, device="cpu")
    _equal(pt, pj)
    _equal(st, sj)
    assert list(spt) == list(spj)
    for k in spj:
        assert dataclasses.asdict(spt[k]) == dataclasses.asdict(spj[k]), k
    assert mt == mj
    _config_equal(TC.config_from_dict(mt["config_dict"]),
                  JC.config_from_dict(mj["config_dict"]))


@pytest.mark.parametrize("name", NAMES)
def test_load_with_dtype_cast_equals_jax(artifacts, name):
    """``dtype`` casts float leaves but not scales, zero points, w_col0 or
    QuantParams."""
    art = artifacts[name]
    pj, sj, _, _ = JC.load_artifact(art, dtype=jnp.bfloat16)
    pt, st, _, _ = TC.load_artifact(art, dtype=torch.bfloat16, device="cpu")
    _equal(pt, pj)
    _equal(st, sj)


def test_what_each_configuration_holds(artifacts):
    """The three artifacts hold what their configurations promise: (a)
    realized W4 codes one per int8 byte, the split ``down`` (in − 1 rows
    and an f32 ``w_col0``) and an fp head; (b) float weights; (c) the
    padded intermediate, an int8 head and the split ``vis.fc2``."""
    pa, _, spa, ma = TC.load_artifact(artifacts["a_real_full"], device="cpu")
    la = pa["llm"]["layers"]
    assert la["gate"]["w_q"].dtype == torch.int8
    codes = la["gate"]["w_q"]
    assert -8 <= int(codes.min()) and int(codes.max()) <= 7
    I = ma["config_dict"]["fields"]["llm"]["fields"]["intermediate"]
    assert la["down"]["w_q"].shape[-2] == I - 1
    assert la["down"]["w_col0"].dtype == torch.float32
    assert "w" in pa["llm"]["lm_head"] and "llm.lm_head" not in spa
    assert spa["llm.down"].online_had == "full" and spa["llm.down"].split
    pb, _, _, _ = TC.load_artifact(artifacts["b_fake"], device="cpu")
    assert "w" in pb["llm"]["layers"]["q"] and "w_q" not in pb["llm"][
        "layers"]["q"]
    pc, _, spc, mc = TC.load_artifact(
        artifacts["c_real_block_head8_vissplit"], device="cpu")
    cfg_c = TC.config_from_dict(mc["config_dict"])
    assert cfg_c.llm.intermediate_pad == 128
    assert pc["llm"]["layers"]["gate"]["w_q"].shape[-1] == 128
    assert pc["llm"]["lm_head"]["w_q"].dtype == torch.int8
    assert spc["vis.fc2"].online_had == "full" and spc["vis.fc2"].split
    assert "w_col0" in pc["vit"]["blocks"]["fc2"]


@pytest.mark.parametrize("name", NAMES)
def test_save_writes_the_same_bytes(artifacts, name, tmp_path):
    """The port's ``save_artifact`` of the trees it loaded writes
    params.msgpack, state.msgpack and meta.json byte-equal to the JAX
    pipeline's, and JAX's ``load_artifact`` reads them back to equal
    trees."""
    art = artifacts[name]
    pt, st, spt, mt = TC.load_artifact(art, device="cpu")
    out = str(tmp_path / "port")
    n = TC.save_artifact(out, pt, st, spt, mt)
    files = ("params.msgpack", "state.msgpack", "meta.json")
    assert all(filecmp.cmp(os.path.join(art, f), os.path.join(out, f),
                           shallow=False) for f in files)
    assert n == sum(os.path.getsize(os.path.join(out, f)) for f in files[:2])
    pj, sj, spj, mj = JC.load_artifact(out)
    _equal(pt, pj)
    _equal(st, sj)
    assert {k: dataclasses.asdict(v) for k, v in spj.items()} == {
        k: dataclasses.asdict(v) for k, v in spt.items()}


def test_port_trees_read_back_by_jax(tmp_path):
    """An artifact the port writes from its own tensors (bf16 leaves, int8
    codes, None slots, QuantParams with and without a zero point, a config
    of its own): JAX's ``load_artifact`` and ``config_from_dict`` give the
    same trees and config."""
    rng = np.random.default_rng(0)
    params_np = {"llm": {
        "embed": {"w": np.asarray(jnp.asarray(rng.normal(size=(16, 8)),
                                              jnp.bfloat16))},
        "layers": {"q": {"w_q": rng.integers(-7, 8, (2, 8, 8)).astype(
            np.int8), "w_scale": rng.random((2, 8)).astype(np.float32),
            "b": None}}}}
    params_t = interop.to_torch(params_np, device="cpu")
    state_t = {"llm.q": {"act": QuantParams(torch.full((2,), 0.05))},
               "llm.o": {"act": QuantParams(torch.tensor(0.1),
                                            torch.tensor(3.0))}}
    specs_t = TQ2.default_w4a8_specs()
    cfg = TQ2.Qwen2VLConfig.tiny()
    art = str(tmp_path / "a")
    TC.save_artifact(art, params_t, state_t, specs_t,
                     {"model": "qwen2vl",
                      "config_dict": TC.config_to_dict(cfg)})
    pj, sj, spj, mj = JC.load_artifact(art)
    _equal(params_t, pj)
    _equal(state_t, sj)
    assert {k: dataclasses.asdict(v) for k, v in spj.items()} == {
        k: dataclasses.asdict(v) for k, v in specs_t.items()}
    cj = JC.config_from_dict(json.loads(json.dumps(mj["config_dict"])))
    assert cj == JQ2.Qwen2VLConfig.tiny()


@pytest.mark.parametrize("preset", ["tiny", "qwen2vl_2b", "qwen2vl_7b",
                                    "qwen2vl_72b"])
def test_config_round_trips_both_ways(preset):
    """JAX's config dict → the port's config, field by field equal; the
    port's config dict → JAX's ``config_from_dict`` → JAX's preset."""
    cj = getattr(JQ2.Qwen2VLConfig, preset)()
    ct = getattr(TQ2.Qwen2VLConfig, preset)()
    d = json.loads(json.dumps(JC.config_to_dict(cj)))
    back = TC.config_from_dict(d)
    assert back == ct
    _config_equal(back, cj)
    assert JC.config_from_dict(json.loads(json.dumps(
        TC.config_to_dict(ct)))) == cj


def _refusals():
    """(class, field, value) of every JAX config field the port does not
    implement at that value, and the values it now does: ChatGLM's
    interleaved rotary, Qwen-VL's CLIP tower flags and the tanh GELU."""
    out = [("DecoderConfig", "rope_interleaved", True),
           ("ViTConfig", "qkv_bias", False), ("ViTConfig", "pre_norm", True),
           ("ViTConfig", "post_norm", True),
           ("ViTConfig", "act", "gelu_tanh")]
    return out


@pytest.mark.parametrize("cls,field,value", _refusals())
def test_config_from_dict_refuses_unported_values(cls, field, value):
    cj = JQ2.Qwen2VLConfig.tiny()
    sub = "llm" if cls == "DecoderConfig" else "vit"
    cj = dataclasses.replace(cj, **{sub: dataclasses.replace(
        getattr(cj, sub), **{field: value})})
    d = json.loads(json.dumps(JC.config_to_dict(cj)))
    if field == "rope_interleaved":  # ported with GLM-4V: read back
        assert TC.config_from_dict(d).llm.rope_interleaved is True
        return
    if field in ("pre_norm", "post_norm", "act"):  # ported with Qwen-VL
        back = TC.config_from_dict(d)
        assert getattr(back.vit, field) == value
        assert JC.config_from_dict(json.loads(json.dumps(
            TC.config_to_dict(back)))) == cj
        return
    with pytest.raises(NotImplementedError, match=rf"{cls}\.{field}.*A\d+"):
        TC.config_from_dict(d)
    # at the value the port implements, the field is accepted
    TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(
        JQ2.Qwen2VLConfig.tiny()))))


@pytest.mark.parametrize("field,value", [
    ("qkv_bias", False), ("o_bias", True), ("rope_partial", 0.5),
    ("use_dynamic_ntk", True), ("ntk_seq_length", 8192),
    ("rope_interleaved", True)])
def test_config_from_dict_takes_decoder_flags(field, value):
    """The decoder flags the port implements (dynamic NTK, partial and
    interleaved RoPE, the q/k/v and o biases) read from JAX's config dict
    and write back to it."""
    cj = JQ2.Qwen2VLConfig.tiny()
    cj = dataclasses.replace(cj, llm=dataclasses.replace(cj.llm,
                                                         **{field: value}))
    back = TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(cj))))
    assert getattr(back.llm, field) == value
    _config_equal(back, cj)
    assert JC.config_from_dict(json.loads(json.dumps(
        TC.config_to_dict(back)))) == cj


@pytest.mark.parametrize("family", ["qwenvl", "minicpmv", "glm4v"])
def test_config_from_dict_refuses_other_families(family):
    """MiniCPM-V's config raises A12; GLM-4V's and Qwen-VL's are ported
    and round-trip to JAX's (Qwen-VL's resampler and CLIP tower flags
    included)."""
    cj = j_family(family).tiny_fn()
    d = json.loads(json.dumps(JC.config_to_dict(cj)))
    if family != "minicpmv":
        back = TC.config_from_dict(d)
        assert back.llm.rope_interleaved == (family == "glm4v")
        if family == "qwenvl":
            assert back.vit.pre_norm and back.resampler.n_queries == 4
        assert JC.config_from_dict(json.loads(json.dumps(
            TC.config_to_dict(back)))) == cj
        return
    with pytest.raises(NotImplementedError, match="A12"):
        TC.config_from_dict(d)


def test_config_from_dict_refuses_unknown_fields():
    d = TC.config_to_dict(TQ2.Qwen2VLConfig.tiny())
    d["fields"]["llm"]["fields"]["rope_scaling"] = 2.0
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        TC.config_from_dict(d)


def test_default_specs_equal_the_pipelines():
    """``default_w4a8_specs`` is what ``build_specs`` gives the default
    QuantizeConfig (the artifact the card's artifact phase writes), field
    by field; and equal to JAX's ``default_w4a8_specs`` for each mode."""
    want = build_specs(j_family("qwen2vl"), QuantizeConfig(realize_int=True))
    got = TQ2.default_w4a8_specs()
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
        k: dataclasses.asdict(v) for k, v in want.items()}
    for kw in (dict(online_had_mode="block"), dict(split=False),
               dict(online_had=False), dict(visual_w_bits=4, a_bits=4)):
        assert {k: dataclasses.asdict(v) for k, v in
                TQ2.default_w4a8_specs(**kw).items()} == {
            k: dataclasses.asdict(v) for k, v in
            JQ2.default_w4a8_specs(**kw).items()}


@pytest.mark.parametrize("name", ["a_real_full",
                                  "c_real_block_head8_vissplit"])
def test_w4_packing_of_pipeline_codes_equals_jax(artifacts, name):
    """The Generator packs the pipeline's W4 codes (one per int8 byte) as
    JAX's ``pack_w4_sites`` does: fused q|k|v and gate|up bytes and o's
    bytes bit-equal; the split ``down`` (odd rows) stays int8."""
    from mquant_tpu.kernels.qmm import pack_w4_sites as j_pack

    art = artifacts[name]
    pj, _, spj, mj = JC.load_artifact(art)
    pt, st, spt, mt = TC.load_artifact(art, device="cpu")
    cfg = TC.config_from_dict(mt["config_dict"])
    gen = Generator(cfg.llm, pt["llm"], specs=spt, state=st, mode="real")
    packed_j = j_pack(pj["llm"]["layers"], spj, cfg.llm.in_dims)
    lt = gen.params["layers"]
    for n in ("q", "gate", "o"):
        key = "w_q" if n == "o" else "w_q_fused"
        np.testing.assert_array_equal(lt[n][key].numpy(),
                                      np.asarray(packed_j[n][key]))
    assert lt["down"]["w_q"].dtype == torch.int8
    assert lt["down"]["w_q"].shape[-2] == cfg.llm.inter_eff - 1


def test_tied_embeddings_match_jax():
    """A decoder with ``tie_embeddings`` (Qwen2-VL-2B's): no lm_head, the
    logits are h · embedᵀ, as JAX's decoder_forward."""
    cfg_j = dataclasses.replace(JQ2.Qwen2VLConfig.tiny().llm,
                                tie_embeddings=True)
    cfg_t = dataclasses.replace(TQ2.Qwen2VLConfig.tiny().llm,
                                tie_embeddings=True)
    pj = JLLM.init_decoder_params(cfg_j, jax.random.key(0))
    assert "lm_head" not in pj
    pt = interop.to_torch(jax.tree.map(np.asarray, pj), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (1, 9))
    lj, _, _ = JLLM.decoder_forward(cfg_j, pj, jnp.asarray(toks))
    lt, _, _ = TLLM.decoder_forward(cfg_t, pt, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-5 * float(np.abs(lj).max()))
    gen = torch.Generator().manual_seed(0)
    assert "lm_head" not in TLLM.init_decoder_params(cfg_t, gen,
                                                     device="cpu")
