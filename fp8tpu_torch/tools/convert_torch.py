"""Foreign torch state_dicts -> the port's models: a copy of the JAX
package's ``tools/convert_torch.py`` (the mappings are NumPy only).

- :func:`convert_resnet` maps a torchvision ResNet state_dict (resnet18 /
  34 / 50 / 101, resnext, wide_resnet: anything built from BasicBlock /
  Bottleneck with the ``layer{L}.{B}.conv{i} / bn{i} / downsample``
  naming) onto Flax-layout variables of ``ResNet(cfg)`` with
  ``norm_mode='bn'``;
- :func:`convert_bert_qa` an HF ``BertForQuestionAnswering`` (or
  ``BertModel`` + qa head) state_dict onto ``BertForQA(cfg)``;
- :func:`convert_vit` a torchvision ``VisionTransformer`` (vit_b_16-class)
  state_dict onto ``ViT(cfg)``,

each exactly as the JAX package's function does, failing on keys it did
not consume (a wrong architecture); ``models.variables_from_flax`` then
gives the port's state_dict.  This is the reference's pretrained-load path
(imagenet_test.py:152-165, run_squad.py's ``--model_name_or_path``;
``examples.resnet_ptq --torch_ckpt``).  As a command it writes the
variables as a checkpoint of the port (``utils.save_checkpoint``, the JAX
package's npz format):

    python -m fp8tpu_torch.tools.convert_torch resnet50 in.pth out_dir
    (kinds: resnet18 | resnet50 | bert_qa | vit_b16)
"""

from __future__ import annotations

import numpy as np


def _np(t):
    """torch.Tensor | ndarray -> float32 / int ndarray on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(t):
    """torch conv weight OIHW -> Flax HWIO (grouped convs included: the I
    axis is already in / groups on both sides)."""
    return np.transpose(_np(t), (2, 3, 1, 0))


def _dense(t):
    return np.ascontiguousarray(_np(t).T)


class _Taken:
    """Tracks which state_dict keys the mapping consumed, so leftovers (a
    wrong architecture guess) fail loudly instead of silently."""

    def __init__(self, sd):
        self.sd = dict(sd)
        self.used = set()

    def __call__(self, key):
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key):
        return key in self.sd

    def leftovers(self, ignore=()):
        return sorted(k for k in self.sd if k not in self.used
                      and not any(k.startswith(p) or k.endswith(p)
                                  for p in ignore))


def convert_resnet(state_dict, cfg) -> dict:
    """torchvision ResNet state_dict -> Flax-layout ResNet variables
    ({"params": ..., "batch_stats": ...}) for ``ResNet(cfg)`` with
    ``norm_mode='bn'``."""
    sd = _Taken(state_dict)
    params, stats = {}, {}

    def norm(pdst, sdst, name, src):
        pdst[name] = {"bn": {"scale": _np(sd(f"{src}.weight")),
                             "bias": _np(sd(f"{src}.bias"))}}
        sdst[name] = {"bn": {"mean": _np(sd(f"{src}.running_mean")),
                             "var": _np(sd(f"{src}.running_var"))}}

    params["conv1"] = {"kernel": _conv(sd("conv1.weight"))}
    norm(params, stats, "norm1", "bn1")

    n_convs = 3 if cfg.bottleneck else 2
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            tp = f"layer{stage + 1}.{b}"
            fp = f"stage{stage}_block{b}"
            bp, bs = {}, {}
            for i in range(1, n_convs + 1):
                bp[f"conv{i}"] = {"kernel": _conv(sd(f"{tp}.conv{i}.weight"))}
                norm(bp, bs, f"norm{i}", f"{tp}.bn{i}")
            if f"{tp}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv(sd(f"{tp}.downsample.0.weight"))}
                norm(bp, bs, "downsample_norm", f"{tp}.downsample.1")
            params[fp] = bp
            stats[fp] = bs

    params["fc"] = {"kernel": _dense(sd("fc.weight")),
                    "bias": _np(sd("fc.bias"))}
    left = sd.leftovers(ignore=("num_batches_tracked",))
    if left:
        raise ValueError(f"unconsumed torch keys (architecture mismatch?): "
                         f"{left[:8]}{'...' if len(left) > 8 else ''}")
    return {"params": params, "batch_stats": stats}


# HF BertForQuestionAnswering key prefix → the Flax module path pieces
_BERT_LAYER_MAP = (
    ("attention.self.query", ("attention", "query")),
    ("attention.self.key", ("attention", "key")),
    ("attention.self.value", ("attention", "value")),
    ("attention.output.dense", ("attention", "output_dense")),
    ("intermediate.dense", ("intermediate",)),
    ("output.dense", ("output",)),
)
_BERT_LAYER_NORMS = (
    ("attention.output.LayerNorm", "attn_norm"),
    ("output.LayerNorm", "ffn_norm"),
)


def convert_bert_qa(state_dict, cfg) -> dict:
    """HF BertForQuestionAnswering (or BertModel + qa head) state_dict →
    the port's ``BertForQA(cfg)`` variables (Flax layout)."""
    sd = _Taken(state_dict)
    bert = {}

    def ln(dst_name, src):
        return {"scale": _np(sd(f"{src}.weight")),
                "bias": _np(sd(f"{src}.bias"))}

    emb = "bert.embeddings"
    bert["word_embed"] = {
        "embedding": _np(sd(f"{emb}.word_embeddings.weight"))}
    bert["pos_embed"] = {
        "embedding": _np(sd(f"{emb}.position_embeddings.weight"))}
    bert["type_embed"] = {
        "embedding": _np(sd(f"{emb}.token_type_embeddings.weight"))}
    bert["embed_norm"] = ln("embed_norm", f"{emb}.LayerNorm")

    for i in range(cfg.n_layers):
        lp = f"bert.encoder.layer.{i}"
        layer = {}
        for src, path in _BERT_LAYER_MAP:
            node = layer
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = {"kernel": _dense(sd(f"{lp}.{src}.weight")),
                              "bias": _np(sd(f"{lp}.{src}.bias"))}
        for src, dst in _BERT_LAYER_NORMS:
            layer[dst] = ln(dst, f"{lp}.{src}")
        bert[f"layer_{i}"] = layer

    params = {"bert": bert,
              "qa_outputs": {"kernel": _dense(sd("qa_outputs.weight")),
                             "bias": _np(sd("qa_outputs.bias"))}}
    left = sd.leftovers(ignore=("position_ids", "bert.pooler"))
    if left:
        raise ValueError(f"unconsumed torch keys (architecture mismatch?): "
                         f"{left[:8]}{'...' if len(left) > 8 else ''}")
    return {"params": params}


def convert_vit(state_dict, cfg) -> dict:
    """torchvision ``VisionTransformer`` state_dict → the port's
    :class:`fp8tpu_torch.models.vision.ViT` variables (Flax layout).

    Naming follows torchvision's vision_transformer.py: ``conv_proj``,
    ``class_token``, ``encoder.pos_embedding``,
    ``encoder.layers.encoder_layer_{i}.{ln_1,self_attention,ln_2,mlp}``
    (the MLP is a Sequential — linears at .0/.3), ``encoder.ln``,
    ``heads.head``.  The fused ``in_proj_weight`` is split into the
    q/k/v Dense kernels (rows [0:D]/[D:2D]/[2D:3D], transposed to
    flax (in, out))."""
    sd = _Taken(state_dict)
    D = cfg.d_model
    params = {
        "patch_embed": {"kernel": _conv(sd("conv_proj.weight")),
                        "bias": _np(sd("conv_proj.bias"))},
        "cls_token": _np(sd("class_token")),
        "pos_embed": _np(sd("encoder.pos_embedding")),
    }

    def ln(src):
        return {"scale": _np(sd(f"{src}.weight")),
                "bias": _np(sd(f"{src}.bias"))}

    for i in range(cfg.n_layers):
        lp = f"encoder.layers.encoder_layer_{i}"
        w = _np(sd(f"{lp}.self_attention.in_proj_weight"))
        b = _np(sd(f"{lp}.self_attention.in_proj_bias"))
        for j, nm in enumerate(("q", "k", "v")):
            params[f"blk{i}_{nm}"] = {
                "kernel": np.ascontiguousarray(w[j * D:(j + 1) * D].T),
                "bias": b[j * D:(j + 1) * D]}
        params[f"blk{i}_proj"] = {
            "kernel": _dense(sd(f"{lp}.self_attention.out_proj.weight")),
            "bias": _np(sd(f"{lp}.self_attention.out_proj.bias"))}
        params[f"blk{i}_ln1"] = ln(f"{lp}.ln_1")
        params[f"blk{i}_ln2"] = ln(f"{lp}.ln_2")
        params[f"blk{i}_fc1"] = {"kernel": _dense(sd(f"{lp}.mlp.0.weight")),
                                 "bias": _np(sd(f"{lp}.mlp.0.bias"))}
        params[f"blk{i}_fc2"] = {"kernel": _dense(sd(f"{lp}.mlp.3.weight")),
                                 "bias": _np(sd(f"{lp}.mlp.3.bias"))}

    params["ln_f"] = ln("encoder.ln")
    params["classifier"] = {"kernel": _dense(sd("heads.head.weight")),
                            "bias": _np(sd("heads.head.bias"))}
    left = sd.leftovers()
    if left:
        raise ValueError(f"unconsumed torch keys (architecture mismatch?): "
                         f"{left[:8]}{'...' if len(left) > 8 else ''}")
    return {"params": params}


def main(argv=None) -> str:
    """``kind src out``: convert the torch checkpoint ``src`` and write it
    to the checkpoint directory ``out`` at step 0."""
    import sys

    import torch

    from fp8tpu_torch.models.bert import bert_base_config
    from fp8tpu_torch.models.resnet import ResNetConfig
    from fp8tpu_torch.models.vision import ViTConfig
    from fp8tpu_torch.utils import save_checkpoint

    kind, src, out = (sys.argv[1:] if argv is None else argv)[:3]
    blob = torch.load(src, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    if kind in ("resnet18", "resnet50"):
        cfg = (ResNetConfig(stage_sizes=(2, 2, 2, 2)) if kind == "resnet18"
               else ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True))
        variables = convert_resnet(sd, cfg)
    elif kind == "bert_qa":
        variables = convert_bert_qa(sd, bert_base_config())
    elif kind == "vit_b16":
        variables = convert_vit(sd, ViTConfig())
    else:
        raise SystemExit(f"unknown kind {kind!r} "
                         "(resnet18 | resnet50 | bert_qa | vit_b16)")
    save_checkpoint(out, 0, variables)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    n = sum(int(np.prod(v.shape)) for v in leaves(variables))
    line = f"converted {kind}: {n/1e6:.1f}M params -> {out}"
    print(line)
    return line


if __name__ == "__main__":
    main()
