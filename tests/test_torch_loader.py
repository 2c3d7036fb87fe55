"""The port's HF checkpoint loader (``mquant_tpu_torch.models.loader``)
against the JAX package's, on tiny random HF Qwen2-VL checkpoints that
``transformers`` writes here (as ``tests/test_loader_parity.py`` does for
JAX), in each layout the loaders read: one safetensors file, a sharded
index, ``pytorch_model.bin``, the older LLM / visual name prefixes
(``model.`` + ``visual.``, ``language_model.model.`` + ``visual.``), and a
tied head (no ``lm_head.weight``).

Every leaf of the port's tree is bit-equal to JAX's ``load_model`` in f32
and in bf16 (each leaf cast as it is loaded, JAX casting its f32 tree),
and the port's forward on the loaded f32 weights is within JAX's
tolerance (2e-3 text logits, 5e-3 merged image features) of the HF model.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from mquant_tpu.models import loader as JL  # noqa: E402
from mquant_tpu.models.llm import DecoderConfig as JDC  # noqa: E402
from mquant_tpu.models.qwen2vl import Qwen2VLConfig as JQC  # noqa: E402
from mquant_tpu.models.vision import MergerConfig as JMC  # noqa: E402
from mquant_tpu.models.vision import ViTConfig as JVC  # noqa: E402
from mquant_tpu_torch.models import loader as TL  # noqa: E402
from mquant_tpu_torch.models.llm import DecoderConfig  # noqa: E402
from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig  # noqa: E402
from mquant_tpu_torch.models.vision import MergerConfig, ViTConfig  # noqa: E402

LAYOUTS = ["single", "sharded", "bin", "prefix-model", "prefix-lm", "tied"]


def _hf(tie: bool):
    from transformers import Qwen2VLConfig as HC
    from transformers import Qwen2VLForConditionalGeneration

    hc = HC(vocab_size=256, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=1e6, tie_word_embeddings=tie,
            rms_norm_eps=1e-6,
            vision_config=dict(depth=2, embed_dim=32, hidden_size=32,
                               num_heads=2, mlp_ratio=1.5, in_chans=3,
                               patch_size=4, spatial_merge_size=2,
                               temporal_patch_size=2),
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
            image_token_id=255, vision_start_token_id=253,
            vision_end_token_id=254)
    torch.manual_seed(1 if tie else 0)
    return Qwen2VLForConditionalGeneration(hc).eval().float()


def _renamed(model, llm_pref: str, vis_pref: str, path):
    """The model's weights under older name prefixes, as one safetensors
    file (written by the ``safetensors`` package)."""
    from safetensors.torch import save_file

    sd = {}
    for k, v in model.state_dict().items():
        k = k.replace("model.language_model.", llm_pref)
        k = k.replace("model.visual.", vis_pref)
        sd[k] = v.contiguous()
    path.mkdir()
    save_file(sd, str(path / "model.safetensors"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    untied, tied = _hf(False), _hf(True)
    out = {}
    untied.save_pretrained(root / "single", safe_serialization=True)
    untied.save_pretrained(root / "sharded", safe_serialization=True,
                           max_shard_size="200KB")
    untied.save_pretrained(root / "bin", safe_serialization=False)
    tied.save_pretrained(root / "tied", safe_serialization=True)
    _renamed(untied, "model.", "visual.", root / "prefix-model")
    _renamed(untied, "language_model.model.", "visual.", root / "prefix-lm")
    for name in LAYOUTS:
        out[name] = str(root / name)
    assert (root / "sharded" / "model.safetensors.index.json").exists()
    assert (root / "bin" / "pytorch_model.bin").exists()
    return {"dirs": out, "untied": untied, "tied": tied}


def _cfgs(dtype_j, dtype_t):
    jc = JQC(name="tiny",
             llm=JDC(vocab=256, hidden=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, intermediate=96, rope_theta=1e6,
                     mrope_sections=(2, 3, 3), dtype=dtype_j),
             vit=JVC(width=32, n_layers=2, n_heads=2, mlp_width=48,
                     patch_dim=2 * 4 * 4 * 3, rotary_2d=True,
                     act="quick_gelu", norm_eps=1e-6, dtype=dtype_j),
             merger=JMC(context_dim=32, out_dim=64, dtype=dtype_j),
             image_token_id=255, patch=4)
    tc = Qwen2VLConfig(
        name="tiny",
        llm=DecoderConfig(vocab=256, hidden=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, intermediate=96, rope_theta=1e6,
                          mrope_sections=(2, 3, 3), dtype=dtype_t),
        vit=ViTConfig(width=32, n_layers=2, n_heads=2, mlp_width=48,
                      patch_dim=2 * 4 * 4 * 3, rotary_2d=True,
                      act="quick_gelu", norm_eps=1e-6, dtype=dtype_t),
        merger=MergerConfig(context_dim=32, out_dim=64, dtype=dtype_t),
        image_token_id=255, patch=4)
    return jc, tc


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _same_tree(j, t, path=""):
    if j is None:
        assert t is None, path
        return
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            _same_tree(j[k], t[k], f"{path}/{k}")
        return
    a, b = _bits(j), _bits(t)
    assert a.shape == b.shape and a.dtype == b.dtype, path
    np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tree_bit_equal_jax(ckpts, layout, dtype):
    dj, dt = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jc, tc = _cfgs(dj, dt)
    d = ckpts["dirs"][layout]
    pj = JL.load_model("qwen2vl", jc, d, dtype=dj)
    pt = TL.load_model("qwen2vl", tc, d, dtype=dt, device="cpu")
    _same_tree(pj, pt)
    if layout == "tied":
        assert torch.equal(pt["llm"]["lm_head"]["w"], pt["llm"]["embed"]["w"].T)


def test_default_dtype_is_f32(ckpts):
    _, tc = _cfgs(jnp.float32, torch.float32)
    pt = TL.load_model("qwen2vl", tc, ckpts["dirs"]["single"], device="cpu")
    assert pt["llm"]["layers"]["q"]["w"].dtype == torch.float32


@pytest.mark.parametrize("layout", ["single", "tied"])
def test_text_logits_match_hf(ckpts, layout):
    from mquant_tpu_torch.models.qwen2vl import qwen2vl_forward

    hf = ckpts["tied" if layout == "tied" else "untied"]
    _, tc = _cfgs(jnp.float32, torch.float32)
    params = TL.load_model("qwen2vl", tc, ckpts["dirs"][layout],
                           dtype=torch.float32, device="cpu")
    ids = torch.arange(10).remainder(250).unsqueeze(0)
    with torch.no_grad():
        ref = hf(input_ids=ids).logits.numpy()
        out, _, _ = qwen2vl_forward(tc, params, ids)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_vision_and_merger_match_hf(ckpts):
    from mquant_tpu_torch.models.vision import (merger_forward,
                                                patchify_qwen2vl, vit_forward)

    hf = ckpts["untied"]
    _, tc = _cfgs(jnp.float32, torch.float32)
    params = TL.load_model("qwen2vl", tc, ckpts["dirs"]["sharded"],
                           dtype=torch.float32, device="cpu")
    torch.manual_seed(1)
    img = torch.randn(1, 3, 16, 16)
    patches, grid = patchify_qwen2vl(img.permute(0, 2, 3, 1), patch=4)
    # HF's visual tower takes (c, t, p, p) per patch; ours is (p, p, t, c)
    pnp = patches[0].reshape(-1, 4, 4, 2, 3)
    hf_flat = pnp.permute(0, 4, 3, 1, 2).reshape(pnp.shape[0], -1)
    with torch.no_grad():
        ref = hf.model.visual(hf_flat, grid_thw=torch.tensor([[1, 4, 4]]))
        feats, _ = vit_forward(tc.vit, params["vit"], patches, grid_hw=grid)
        merged, _ = merger_forward(tc.merger, params["merger"], feats)
    np.testing.assert_allclose(merged[0].numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_other_families_raise_a12(tmp_path):
    """MiniCPM-V's loader raises A12c; Qwen2-VL's, Qwen-VL's, InternVL2's
    and GLM-4V's are ported, and a directory without a checkpoint raises
    FileNotFoundError."""
    for fam in ("minicpmv",):
        with pytest.raises(NotImplementedError, match="A12"):
            TL.load_model(fam, None, str(tmp_path), device="cpu")
    from mquant_tpu_torch.models.glm4v import GLM4VConfig
    from mquant_tpu_torch.models.qwenvl import QwenVLConfig

    for fam, cfg in (("qwen2vl", _cfgs(jnp.float32, torch.float32)[1]),
                     ("glm4v", GLM4VConfig.tiny()),
                     ("qwenvl", QwenVLConfig.tiny())):
        with pytest.raises(FileNotFoundError):
            TL.load_model(fam, cfg, str(tmp_path), device="cpu")


def test_save_hf_round_trip(ckpts, tmp_path):
    """``save_qwen2vl_hf`` undoes the surgery: the port's tree of the
    transformers checkpoint, written back in small shards, holds every
    tensor of the checkpoint under its name, bit for bit, with an index
    that maps each; loading it gives the tree again."""
    from safetensors.numpy import load_file

    hf = ckpts["untied"]
    _, tc = _cfgs(jnp.float32, torch.float32)
    tree = TL.load_model("qwen2vl", tc, ckpts["dirs"]["single"],
                         dtype=torch.float32, device="cpu")
    out = tmp_path / "hf"
    n = TL.save_qwen2vl_hf(tc, tree, str(out), max_shard_bytes=100_000)
    index = json.loads((out / "model.safetensors.index.json").read_text())
    shards = sorted(p.name for p in out.glob("model-*.safetensors"))
    assert len(shards) > 2 and n == sum((out / s).stat().st_size
                                        for s in shards)
    assert set(index["weight_map"].values()) == set(shards)
    got = {}
    for s in shards:
        got.update(load_file(str(out / s)))
    want = {k: v.numpy() for k, v in hf.state_dict().items()}
    assert set(got) == set(want) == set(index["weight_map"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _same_tree(tree, TL.load_model("qwen2vl", tc, str(out),
                                   dtype=torch.float32, device="cpu"))
