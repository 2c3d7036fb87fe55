"""Quantization artifacts (counterpart of ``mquant_tpu/utils/checkpoint.py``).

An artifact is one directory, written by the JAX pipeline
(``run_pipeline(..., artifact_dir=...)``) or by :func:`save_artifact`:

    params.msgpack   the weight tree (float, or realized int storage)
    state.msgpack    static activation QuantParams per site (optional)
    meta.json        specs, model config, quantize config, rotation info

The msgpack files are flax's format, read and written by
:mod:`mquant_tpu_torch.utils.msgpack`. A None slot is stored as
``{"__none__": int8[0]}`` and a QuantParams as a dict tagged
``"__namedtuple__": "QuantParams"``. ``meta["config_dict"]`` is the model
config as :func:`config_to_dict` encodes it; :func:`config_from_dict` maps it
onto the port's dataclasses and refuses a field the port does not
implement at the value given.

:func:`export_safetensors` / :func:`import_safetensors` write and read a
params or state tree as one ``.safetensors`` file (the JAX module's
interop, byte for byte): tensors under their "/"-joined paths, the tree's
structure (dicts, QuantParams / ObserverStats named tuples, None slots) in
the metadata key ``mquant_structure``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.quant import QuantParams
from . import msgpack

# Quantization metadata that stays full precision under load_artifact's
# dtype cast (the JAX module's set): dequant scales, zero points and the
# fp-kept RMS-split column
_NO_CAST_KEYS = frozenset({"w_scale", "scale", "zero_point", "w_col0",
                           "k_scale", "v_scale", "k_zp", "v_zp"})


def _to_serializable(tree):
    if tree is None:
        return {"__none__": torch.zeros((0,), dtype=torch.int8)}
    if isinstance(tree, dict):
        return {k: _to_serializable(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"__namedtuple__": type(tree).__name__,
                **{k: _to_serializable(v) for k, v in tree._asdict().items()}}
    return tree


def _from_serializable(t, dtype, device):
    if isinstance(t, dict):
        if "__none__" in t:
            return None
        if t.get("__namedtuple__") == "QuantParams":
            return QuantParams(_from_serializable(t["scale"], None, device),
                               _from_serializable(t["zero_point"], None,
                                                  device))
        return {k: _from_serializable(v, None if k in _NO_CAST_KEYS
                                      else dtype, device)
                for k, v in t.items() if k != "__namedtuple__"}
    if not isinstance(t, (torch.Tensor, msgpack.Chunked)):
        return t
    out = msgpack.to_tensor(t, device)
    if dtype is not None and out.is_floating_point():
        out = out.to(dtype)
    return out


def save_artifact(path: str, params: Dict, state: Optional[Dict] = None,
                  specs: Optional[Dict] = None, meta: Optional[Dict] = None
                  ) -> int:
    """Writes the artifact directory (tensors on any device, streamed leaf
    by leaf); returns the bytes of the two msgpack files."""
    os.makedirs(path, exist_ok=True)
    n = msgpack.dump(_to_serializable(params),
                     os.path.join(path, "params.msgpack"))
    if state is not None:
        n += msgpack.dump(_to_serializable(state),
                          os.path.join(path, "state.msgpack"))
    m = dict(meta or {})
    if specs is not None:
        m["specs"] = {k: dataclasses.asdict(v) for k, v in specs.items()}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(m, f, indent=1, default=str)
    return n


def load_artifact(path: str, dtype: Optional[torch.dtype] = None,
                  device="cuda") -> Tuple[Dict, Optional[Dict], Dict, Dict]:
    """(params, state, specs, meta) on ``device`` (the card unless the
    caller asks for another). ``dtype`` casts the float leaves except
    those under :data:`_NO_CAST_KEYS` and the QuantParams."""
    from ..models.layers import SiteSpec

    params = _from_serializable(
        msgpack.load(os.path.join(path, "params.msgpack")), dtype, device)
    state = None
    sp = os.path.join(path, "state.msgpack")
    if os.path.exists(sp):
        state = _from_serializable(msgpack.load(sp), None, device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    specs = {}
    for k, v in meta.pop("specs", {}).items():
        v = dict(v)
        v["online_had"] = v.get("online_had") or None
        for fk in ("w_bits", "a_bits", "out_bits"):
            if v.get(fk) in ("None", None):
                v[fk] = None
            elif isinstance(v[fk], str):
                v[fk] = int(v[fk])
        specs[k] = SiteSpec(**v)
    return params, state, specs, meta


# ---------------------------------------------------------------------------
# model configs
# ---------------------------------------------------------------------------

# Fields of the JAX package's configs that the port's dataclasses lack: the
# one value the port implements, and the ROADMAP item that ports the rest
_UNPORTED = {
    "ViTConfig": {"qkv_bias": (True, "A12")},
}
# fields the port's dataclasses have, with the values the port implements
_PORTED_VALUES = {("ViTConfig", "act"): (("gelu", "quick_gelu", "gelu_tanh"),
                                         "A12")}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _config_classes() -> Dict[str, type]:
    from ..models.buckets import BucketSpec
    from ..models.glm4v import GLM4VConfig
    from ..models.internvl import InternVLConfig
    from ..models.llm import DecoderConfig
    from ..models.projectors import GluProjectorConfig, Mlp1Config
    from ..models.qwen2vl import Qwen2VLConfig
    from ..models.qwenvl import QwenVLConfig
    from ..models.resampler import ResamplerConfig
    from ..models.vision import MergerConfig, ViTConfig

    return {c.__name__: c for c in (Qwen2VLConfig, QwenVLConfig,
                                    InternVLConfig, GLM4VConfig,
                                    DecoderConfig, ViTConfig, MergerConfig,
                                    ResamplerConfig, Mlp1Config,
                                    GluProjectorConfig, BucketSpec)}


def config_to_dict(cfg) -> Dict:
    """Nested config dataclass → JSON-safe dict in the JAX package's
    encoding (class names by value, dtypes by name, tuples tagged), which
    its ``config_from_dict`` reads back."""

    def enc(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {"__class__": type(v).__name__,
                    "fields": {f.name: enc(getattr(v, f.name))
                               for f in dataclasses.fields(v)}}
        if isinstance(v, tuple):
            return {"__tuple__": [enc(x) for x in v]}
        if isinstance(v, list):
            return [enc(x) for x in v]
        if isinstance(v, torch.dtype):
            return {"__dtype__": str(v).removeprefix("torch.")}
        return v

    return enc(cfg)


def config_from_dict(d: Dict) -> Any:
    """Inverse of :func:`config_to_dict`, also for the dicts the JAX
    package writes: each field the port's class lacks must hold the value
    the port implements (else NotImplementedError names the ROADMAP item
    that ports it); a class the port lacks names A12."""
    classes = _config_classes()

    def dec(v):
        if isinstance(v, dict) and "__class__" in v:
            name = v["__class__"]
            if name not in classes:
                raise NotImplementedError(
                    f"config class {name} is not ported (ROADMAP A12)")
            cls = classes[name]
            own = {f.name for f in dataclasses.fields(cls)}
            kw = {}
            for k, x in v["fields"].items():
                x = dec(x)
                if k in own:
                    ok, item = _PORTED_VALUES.get((name, k), (None, None))
                    if ok is not None and x not in ok:
                        raise NotImplementedError(
                            f"{name}.{k} = {x!r} is not ported (ROADMAP "
                            f"{item})")
                    kw[k] = x
                    continue
                if k not in _UNPORTED.get(name, {}):
                    raise NotImplementedError(
                        f"{name}.{k} is not a field of the port's {name}")
                want, item = _UNPORTED[name][k]
                if x != want:
                    raise NotImplementedError(
                        f"{name}.{k} = {x!r} is not ported (ROADMAP {item})")
            return cls(**kw)
        if isinstance(v, dict) and "__tuple__" in v:
            return tuple(dec(x) for x in v["__tuple__"])
        if isinstance(v, dict) and "__dtype__" in v:
            if v["__dtype__"] not in _DTYPES:
                raise NotImplementedError(f"dtype {v['__dtype__']} is not "
                                          "ported")
            return _DTYPES[v["__dtype__"]]
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return dec(d)


# ---------------------------------------------------------------------------
# safetensors interop
# ---------------------------------------------------------------------------


def _st_flatten(tree, prefix: str, out: Dict, meta: Dict):
    """Tensors of ``tree`` under "/"-joined paths into ``out``; each node's
    kind ("dict", "none", "nt:<class>") under its path into ``meta``."""
    if tree is None:
        meta[prefix] = "none"
        return
    if isinstance(tree, dict):
        meta[prefix] = "dict"
        for k, v in tree.items():
            assert "/" not in str(k), k
            _st_flatten(v, f"{prefix}/{k}" if prefix else str(k), out, meta)
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        meta[prefix] = f"nt:{type(tree).__name__}"
        for k, v in tree._asdict().items():
            _st_flatten(v, f"{prefix}/{k}", out, meta)
        return
    out[prefix] = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
        tree)


def _nt_class(name: str):
    from ..observe.observers import ObserverStats

    return {"QuantParams": QuantParams, "ObserverStats": ObserverStats}[name]


def export_safetensors(tree: Dict, path: str,
                       extra_meta: Optional[Dict] = None) -> int:
    """Write a params / state tree (tensors on any device) as one
    .safetensors file, bf16 stored as BF16; returns its bytes."""
    from . import safetensors as st

    out: Dict[str, torch.Tensor] = {}
    meta: Dict[str, str] = {}
    _st_flatten(tree, "", out, meta)
    md = {"mquant_structure": json.dumps(meta)}
    if extra_meta:
        md.update({k: str(v) for k, v in extra_meta.items()})
    return st.save_file(out, path, metadata=md)


def import_safetensors(path: str, device="cuda") -> Tuple[Dict, Dict]:
    """Inverse of :func:`export_safetensors` → (tree on ``device``, the
    metadata without ``mquant_structure``); named tuples are rebuilt
    bottom-up as the port's classes."""
    from . import safetensors as st

    with st.SafeOpen(path) as f:
        md = dict(f.metadata() or {})
        flat = {k: f.get_tensor(k, device=device) for k in f.keys()}
    meta = json.loads(md.pop("mquant_structure"))
    root: Dict = {}

    def set_path(key: str, val):
        parts = key.split("/") if key else []
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        if parts:
            cur[parts[-1]] = val

    for k, v in flat.items():
        set_path(k, v)
    for k, kind in meta.items():
        if kind == "none":
            set_path(k, None)
    for k, kind in sorted(meta.items(), key=lambda kv: -kv[0].count("/")):
        if not kind.startswith("nt:"):
            continue
        cls = _nt_class(kind[3:])
        parts = k.split("/") if k else []
        cur = root
        for p in parts[:-1]:
            cur = cur[p]
        node = cur[parts[-1]] if parts else root
        nt = cls(**{f: node.get(f) for f in cls._fields})
        if parts:
            cur[parts[-1]] = nt
        else:
            root = nt
    return root, md
