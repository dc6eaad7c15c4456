"""The image-quality towers and metrics in the port against the JAX package.

Weights are drawn from a numpy seed as the checkpoints' torch-layout state
dicts at the tiny configs (CLIP_DUAL_TINY, BLIP_REWARD_TINY; the MPS cross
model at the tiny projection width, 2 heads of 64) and fed to both
packages' converters: HF CLIPModel and open_clip layouts, the MPS
Cross_model and ImageReward. A JAX tree also crosses through
`from_jax_params`. Both packages get the same `StubTokenizer` instance.
fp32; tolerance 1e-4 of the largest magnitude (sums in other orders).
"""
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import video_styler_tpu.extensions.image_quality_metric as JQ
import video_styler_tpu.models.blip_reward as JB
import video_styler_tpu.models.clip_dual as JC

import video_styler_tpu_torch.extensions.image_quality_metric as TQ
import video_styler_tpu_torch.models.blip_reward as TB
import video_styler_tpu_torch.models.clip_dual as TC
from video_styler_tpu_torch.convert import from_jax_params

from test_torch_pipeline import cpu_share  # noqa: F401  (autouse)

TOL = 1e-4
CFG = JC.CLIP_DUAL_TINY
BCFG = JB.BLIP_REWARD_TINY


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _draw(shapes, seed):
    """LayerNorm weights 1 + N(0, 0.1^2), other 1-D tensors N(0, 0.1^2),
    matrices and convolutions N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        low = name.lower()
        if len(shape) > 1:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif any(k in low for k in ("norm", "ln_", "layrnorm", "ln_final")) and \
                name.endswith("weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def _hf_clip_shapes(c):
    g = c.image_size // c.patch_size
    s = {"vision_model.embeddings.patch_embedding.weight": (c.vision_dim, 3, c.patch_size,
                                                           c.patch_size),
         "vision_model.embeddings.class_embedding": (c.vision_dim,),
         "vision_model.embeddings.position_embedding.weight": (g * g + 1, c.vision_dim),
         "text_model.embeddings.token_embedding.weight": (c.vocab_size, c.text_dim),
         "text_model.embeddings.position_embedding.weight": (c.max_len, c.text_dim),
         "visual_projection.weight": (c.proj_dim, c.vision_dim),
         "text_projection.weight": (c.proj_dim, c.text_dim)}
    for ln, d in (("vision_model.pre_layrnorm", c.vision_dim),
                  ("vision_model.post_layernorm", c.vision_dim),
                  ("text_model.final_layer_norm", c.text_dim)):
        s[f"{ln}.weight"] = s[f"{ln}.bias"] = (d,)
    for tower, n, d in (("vision", c.vision_layers, c.vision_dim),
                        ("text", c.text_layers, c.text_dim)):
        for i in range(n):
            p = f"{tower}_model.encoder.layers.{i}"
            for ln in ("layer_norm1", "layer_norm2"):
                s[f"{p}.{ln}.weight"] = s[f"{p}.{ln}.bias"] = (d,)
            for a in ("q_proj", "k_proj", "v_proj", "out_proj"):
                s[f"{p}.self_attn.{a}.weight"], s[f"{p}.self_attn.{a}.bias"] = (d, d), (d,)
            s[f"{p}.mlp.fc1.weight"], s[f"{p}.mlp.fc1.bias"] = (4 * d, d), (4 * d,)
            s[f"{p}.mlp.fc2.weight"], s[f"{p}.mlp.fc2.bias"] = (d, 4 * d), (d,)
    return s


def _open_clip_shapes(c):
    g = c.image_size // c.patch_size
    s = {"visual.conv1.weight": (c.vision_dim, 3, c.patch_size, c.patch_size),
         "visual.class_embedding": (c.vision_dim,),
         "visual.positional_embedding": (g * g + 1, c.vision_dim),
         "visual.proj": (c.vision_dim, c.proj_dim),
         "token_embedding.weight": (c.vocab_size, c.text_dim),
         "positional_embedding": (c.max_len, c.text_dim),
         "text_projection": (c.text_dim, c.proj_dim)}
    for ln, d in (("visual.ln_pre", c.vision_dim), ("visual.ln_post", c.vision_dim),
                  ("ln_final", c.text_dim)):
        s[f"{ln}.weight"] = s[f"{ln}.bias"] = (d,)
    for prefix, n, d in (("visual.transformer", c.vision_layers, c.vision_dim),
                         ("transformer", c.text_layers, c.text_dim)):
        for i in range(n):
            p = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                s[f"{p}.{ln}.weight"] = s[f"{p}.{ln}.bias"] = (d,)
            s[f"{p}.attn.in_proj_weight"], s[f"{p}.attn.in_proj_bias"] = (3 * d, d), (3 * d,)
            s[f"{p}.attn.out_proj.weight"], s[f"{p}.attn.out_proj.bias"] = (d, d), (d,)
            s[f"{p}.mlp.c_fc.weight"], s[f"{p}.mlp.c_fc.bias"] = (4 * d, d), (4 * d,)
            s[f"{p}.mlp.c_proj.weight"], s[f"{p}.mlp.c_proj.bias"] = (d, 4 * d), (d,)
    return s


def _cross_shapes(dim, heads=2, dim_head=64, layers=4):
    inner, ff = heads * dim_head, 4 * dim
    s = {}
    for i in range(layers):
        c, p = f"cross_model.layers.{i}.0.fn", f"cross_model.layers.{i}.1.fn"
        s.update({f"{c}.norm.weight": (dim,), f"{c}.to_q.weight": (inner, dim),
                  f"{c}.to_kv.weight": (2 * dim_head, dim), f"{c}.to_out.weight": (dim, inner),
                  f"{c}.ff.0.weight": (2 * ff, dim), f"{c}.ff.2.weight": (dim, ff),
                  f"{p}.norm.weight": (dim,),
                  f"{p}.fused_attn_ff_proj.weight": (inner + 2 * dim_head + 2 * ff, dim),
                  f"{p}.attn_out.weight": (dim, inner), f"{p}.ff_out.1.weight": (dim, ff)})
    return s


def _image_reward_shapes(c):
    g = c.image_size // c.patch_size
    v, t, d, td = "blip.visual_encoder", "blip.text_encoder", c.vit_dim, c.text_dim
    s = {f"{v}.patch_embed.proj.weight": (d, 3, c.patch_size, c.patch_size),
         f"{v}.patch_embed.proj.bias": (d,), f"{v}.cls_token": (1, 1, d),
         f"{v}.pos_embed": (1, g * g + 1, d), f"{v}.norm.weight": (d,), f"{v}.norm.bias": (d,),
         f"{t}.embeddings.word_embeddings.weight": (c.vocab_size, td),
         f"{t}.embeddings.position_embeddings.weight": (c.max_pos, td),
         f"{t}.embeddings.LayerNorm.weight": (td,), f"{t}.embeddings.LayerNorm.bias": (td,)}
    for i in range(c.vit_layers):
        p = f"{v}.blocks.{i}"
        for ln in ("norm1", "norm2"):
            s[f"{p}.{ln}.weight"] = s[f"{p}.{ln}.bias"] = (d,)
        for name, o, i_ in (("attn.qkv", 3 * d, d), ("attn.proj", d, d),
                            ("mlp.fc1", 4 * d, d), ("mlp.fc2", d, 4 * d)):
            s[f"{p}.{name}.weight"], s[f"{p}.{name}.bias"] = (o, i_), (o,)
    for i in range(c.text_layers):
        p = f"{t}.encoder.layer.{i}"
        for att, kv in (("attention", td), ("crossattention", d)):
            for name, o, i_ in (("self.query", td, td), ("self.key", td, kv),
                                ("self.value", td, kv), ("output.dense", td, td)):
                s[f"{p}.{att}.{name}.weight"], s[f"{p}.{att}.{name}.bias"] = (o, i_), (o,)
            s[f"{p}.{att}.output.LayerNorm.weight"] = (td,)
            s[f"{p}.{att}.output.LayerNorm.bias"] = (td,)
        s[f"{p}.intermediate.dense.weight"] = (c.text_ffn, td)
        s[f"{p}.intermediate.dense.bias"] = (c.text_ffn,)
        s[f"{p}.output.dense.weight"], s[f"{p}.output.dense.bias"] = (td, c.text_ffn), (td,)
        s[f"{p}.output.LayerNorm.weight"] = s[f"{p}.output.LayerNorm.bias"] = (td,)
    dims = (td, 1024, 128, 64, 16, 1)
    for j, i in enumerate(("0", "2", "4", "6", "7")):
        s[f"mlp.layers.{i}.weight"], s[f"mlp.layers.{i}.bias"] = (dims[j + 1], dims[j]), \
            (dims[j + 1],)
    return s


class StubTokenizer:
    """Deterministic ids from the text (crc32 seed): `length` tokens, EOS,
    then two padding tokens masked out."""

    def __init__(self, vocab, eos, length):
        self.vocab, self.eos, self.length = vocab, eos, length

    def __call__(self, texts, **kw):
        rng = np.random.default_rng(zlib.crc32(texts[0].encode()))
        ids = rng.integers(2, self.vocab - 1, (len(texts), self.length)).astype(np.int64)
        mask = np.ones_like(ids)
        ids[:, -3], ids[:, -2:], mask[:, -2:] = self.eos, 0, 0
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def towers():
    hf = {**_draw(_hf_clip_shapes(CFG), 0), "logit_scale": np.float32(np.log(80.0))}
    oc = {**_draw(_open_clip_shapes(CFG), 1), "logit_scale": np.float32(np.log(90.0))}
    cross = _draw(_cross_shapes(CFG.proj_dim), 2)
    ir = _draw(_image_reward_shapes(BCFG), 3)
    return dict(hf=hf, oc=oc, cross=cross, ir=ir,
                j_hf=JC.convert_hf_clip(hf, CFG), t_hf=TC.convert_hf_clip(hf, CFG, "cpu"),
                j_oc=JC.convert_open_clip(oc, CFG), t_oc=TC.convert_open_clip(oc, CFG, "cpu"),
                j_cross=JC.convert_cross_model(cross),
                t_cross=TC.convert_cross_model(cross, device="cpu"),
                j_ir=JB.convert_image_reward(ir, BCFG),
                t_ir=TB.convert_image_reward(ir, BCFG, "cpu"))


def _pixels(n, size, seed=4):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _ids(n=2, length=CFG.max_len):
    tok = StubTokenizer(CFG.vocab_size, CFG.eos_token_id, length)
    t = tok(["a cat on a mat"] * n)
    return t["input_ids"], t["attention_mask"]


@pytest.mark.parametrize("layout", ["hf", "oc"])
def test_clip_towers_match_jax(towers, layout):
    jp, tp = towers[f"j_{layout}"], towers[f"t_{layout}"]
    pix = _pixels(2, CFG.image_size)
    ids, mask = _ids()
    with torch.no_grad():
        tt, tpool = TC.clip_vision_forward(tp, CFG, torch.from_numpy(pix))
        jt, jpool = JC.clip_vision_forward(jp, CFG, pix)
        _close(tt, jt)
        _close(tpool, jpool)
        for m in (None, mask):
            tt, tpool = TC.clip_text_forward(tp, CFG, ids, m)
            jt, jpool = JC.clip_text_forward(jp, CFG, ids, m)
            _close(tt, jt)
            _close(tpool, jpool)
        _close(TC.clip_image_features(tp, CFG, torch.from_numpy(pix)),
               JC.clip_image_features(jp, CFG, pix))
        _close(TC.clip_text_features(tp, CFG, ids, mask), JC.clip_text_features(jp, CFG, ids, mask))
    assert float(tp.logit_scale) == jp["logit_scale"]


def test_cross_model_matches_jax(towers):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, CFG.proj_dim)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, CFG.proj_dim)).astype(np.float32)
    mask = np.where(rng.random((2, 5, 7)) > 0.3, 0.0, -np.inf).astype(np.float32)
    mask[..., 0] = 0.0  # every query row sees a key
    with torch.no_grad():
        got = TC.cross_model_forward(towers["t_cross"], torch.from_numpy(q), torch.from_numpy(ctx),
                                     torch.from_numpy(mask), heads=2)
    _close(got, JC.cross_model_forward(towers["j_cross"], q, ctx, mask, heads=2))


def test_blip_reward_matches_jax(towers):
    jp, tp = towers["j_ir"], towers["t_ir"]
    pix = _pixels(2, BCFG.image_size, seed=6)
    tok = StubTokenizer(BCFG.vocab_size, BCFG.vocab_size - 1, 7)(["a bird"] * 2)
    with torch.no_grad():
        tv = TB.blip_vit_forward(tp, BCFG, torch.from_numpy(pix))
        jv = JB.blip_vit_forward(jp, BCFG, pix)
        _close(tv, jv)
        _close(TB.blip_bert_forward(tp, BCFG, tok["input_ids"], tok["attention_mask"], tv),
               JB.blip_bert_forward(jp, BCFG, tok["input_ids"], tok["attention_mask"], jv))
        _close(TB.image_reward_forward(tp, BCFG, torch.from_numpy(pix), tok["input_ids"],
                                       tok["attention_mask"]),
               JB.image_reward_forward(jp, BCFG, pix, tok["input_ids"], tok["attention_mask"]))


def _tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


def test_from_jax_params(towers):
    import jax
    pix = _pixels(1, CFG.image_size, seed=7)
    ids, mask = _ids(1)
    for jp in (towers["j_hf"], JC.init_clip_dual(jax.random.PRNGKey(0), CFG)):
        tp = from_jax_params("clip_dual", _tree(jp), CFG, device="cpu")
        with torch.no_grad():
            _close(TC.clip_image_features(tp, CFG, torch.from_numpy(pix)),
                   JC.clip_image_features(jp, CFG, pix))
            _close(TC.clip_text_features(tp, CFG, ids, mask),
                   JC.clip_text_features(jp, CFG, ids, mask))
        assert float(tp.logit_scale) == jp["logit_scale"]
    tc = from_jax_params("cross_model", _tree(towers["j_cross"]), None, device="cpu")
    assert tc.cfg == TC.CrossModelConfig(dim=CFG.proj_dim, heads=2)
    ti = from_jax_params("blip_reward", _tree(towers["j_ir"]), BCFG, device="cpu")
    tok = StubTokenizer(BCFG.vocab_size, BCFG.vocab_size - 1, 7)(["a bird"])
    bp = _pixels(1, BCFG.image_size, seed=8)
    with torch.no_grad():
        _close(TB.image_reward_forward(ti, BCFG, torch.from_numpy(bp), tok["input_ids"],
                                       tok["attention_mask"]),
               JB.image_reward_forward(towers["j_ir"], BCFG, bp, tok["input_ids"],
                                       tok["attention_mask"]))


def _images(n, size=64, seed=9):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (size, size + 10, 3), dtype=np.uint8))
            for _ in range(n)]


def test_preprocess_matches_jax():
    for im in _images(2, size=50):
        np.testing.assert_array_equal(TQ.preprocess_metric_image(im, 28),
                                      JQ.preprocess_metric_image(im, 28))
        np.testing.assert_array_equal(TQ.preprocess_metric_image(np.asarray(im), 28),
                                      JQ.preprocess_metric_image(np.asarray(im), 28))


def test_six_metrics_match_jax(towers):
    tok = StubTokenizer(CFG.vocab_size, CFG.eos_token_id, CFG.max_len)
    imgs = _images(3)
    # aesthetic head at its published widths
    aes = _draw({f"layers.{i}.{k}": (b, a) if k == "weight" else (b,)
                 for i, (a, b) in zip(("0", "2", "4", "6", "7"),
                                      JQ.AestheticPredictor.LAYER_DIMS)
                 for k in ("weight", "bias")}, 10)
    emb = np.random.default_rng(11).standard_normal((3, 768)).astype(np.float32)
    _close(TQ.AestheticPredictor.from_state_dict(aes, device="cpu").score_embeddings(emb),
           JQ.AestheticPredictor.from_state_dict(aes).score_embeddings(emb))
    # CLIP score over each package's towers
    jfn = (lambda ims: JC.clip_image_features(towers["j_hf"], CFG, JQ._as_pixel_batch(ims, 28)),
           lambda txt: JC.clip_text_features(towers["j_hf"], CFG, tok(txt)["input_ids"]))
    tfn = (lambda ims: TC.clip_image_features(
               towers["t_hf"], CFG, TQ._as_pixel_batch(ims, 28, "cpu")).detach(),
           lambda txt: TC.clip_text_features(towers["t_hf"], CFG,
                                             tok(txt)["input_ids"]).detach())
    scores = {"clip": (TQ.CLIPScore(*tfn).score(imgs, "a cat"),
                       JQ.CLIPScore(*jfn).score(imgs, "a cat"))}
    for name, jm, tm in (
            ("pickscore", JQ.PickScore(towers["j_hf"], CFG, tok),
             TQ.PickScore(towers["t_hf"], CFG, tok)),
            ("hps", JQ.HPScore(towers["j_oc"], CFG, tok), TQ.HPScore(towers["t_oc"], CFG, tok)),
            ("mps", JQ.MPScore(towers["j_hf"], towers["j_cross"], CFG, tok, cross_heads=2),
             TQ.MPScore(towers["t_hf"], towers["t_cross"], CFG, tok, cross_heads=2)),
            ("imagereward", JQ.ImageRewardScore(towers["j_ir"], BCFG, StubTokenizer(
                BCFG.vocab_size, BCFG.vocab_size - 1, 7)),
             TQ.ImageRewardScore(towers["t_ir"], BCFG, StubTokenizer(
                 BCFG.vocab_size, BCFG.vocab_size - 1, 7)))):
        scores[name] = (tm.score(imgs, "a cat"), jm.score(imgs, "a cat"))
    scores["pickscore_softmax"] = (
        TQ.PickScore(towers["t_hf"], CFG, tok).score(imgs, "a cat", softmax=True),
        JQ.PickScore(towers["j_hf"], CFG, tok).score(imgs, "a cat", softmax=True))
    for name, (got, want) in scores.items():
        assert len(got) == 3 and np.isfinite(got).all(), name
        _close(np.asarray(got), want)
    assert abs(sum(scores["pickscore_softmax"][0]) - 1.0) < 1e-6


def test_from_state_dict_and_registry(towers):
    tok = StubTokenizer(CFG.vocab_size, CFG.eos_token_id, CFG.max_len)
    imgs = _images(1)
    mps_sd = {**towers["hf"], **towers["cross"]}
    got = TQ.MPScore.from_state_dict(mps_sd, CFG, tok, device="cpu")
    got.cross_heads = 2
    want = JQ.MPScore.from_state_dict(mps_sd, CFG, tok)
    want.cross_heads = 2
    _close(np.asarray(got.score(imgs, "a dog")), want.score(imgs, "a dog"))
    _close(np.asarray(TQ.HPScore.from_state_dict(towers["oc"], CFG, tok, "cpu").score(imgs, "x")),
           JQ.HPScore.from_state_dict(towers["oc"], CFG, tok).score(imgs, "x"))
    assert isinstance(TQ.get_metric("pickscore", params=towers["t_hf"], cfg=CFG), TQ.PickScore)
    with pytest.raises(TypeError):
        TQ.get_metric("pickscore")
    with pytest.raises(ValueError):
        TQ.get_metric("nope")
