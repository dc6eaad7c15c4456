"""The two `transformers` backends of the port against its native paths on
the same weights, beside the JAX package's fallbacks.

`QwenImagePipeline.fetch_text_encoder(backend="transformers")` loads HF's
`Qwen2_5_VLForConditionalGeneration` and `HunyuanVideoPipeline.fetch_llm(
backend="transformers")` HF's `LlamaModel`, each from a tiny model built
from a config and written with `save_pretrained` (which writes the
reference's key names, `model.layers.*` and `visual.*` for Qwen2.5-VL, bare
`layers.*` for a `LlamaModel`, so the native loaders read the same file).
Widths: text towers of 2 (Qwen) and 3 (LLaMA) layers, 2 heads of 128 and
one k/v head over a 128-token vocabulary (heads of 128 so that the native
`detect_decoder_lm_config` reads them), a 2-block vision tower of 2 heads
of 80. fp32 within 2e-5 relative L2.

The JAX fallbacks depart from both: its Qwen backend calls
`AutoModelForCausalLM`, which refuses a Qwen2.5-VL directory (ValueError);
its LLaMA backend returns `last_hidden_state` (every layer, then the final
norm) where the native paths of both packages take layer n - 2 without the
norm. The tests pin both and the size of the second difference: relative
L2 25.0 and 26.3 on these weights (the normed output is ~26x the layer's).
"""
import numpy as np
import pytest
import torch

import video_styler_tpu.pipelines.hunyuan_video as JH
import video_styler_tpu.pipelines.qwen_image as JQ

import video_styler_tpu_torch.pipelines.hunyuan_video as TH
import video_styler_tpu_torch.pipelines.qwen_image as TQ
from video_styler_tpu_torch.models.qwen_vl_embedder import StubQwenTokenizer

from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401

TOL_F32 = 2e-5
VOCAB = 128
PROMPTS = ("a red fox running through deep snow at dawn", "")


def _text_config(layers: int, theta: float, eps: float) -> dict:
    return dict(vocab_size=VOCAB, hidden_size=256, num_hidden_layers=layers,
                num_attention_heads=2, num_key_value_heads=1, intermediate_size=128,
                rope_theta=theta, rms_norm_eps=eps)


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    """A tiny Qwen2.5-VL (both towers) with random weights, saved by HF."""
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration
    tok = StubQwenTokenizer(VOCAB)
    ids = tok.special_ids
    text = dict(_text_config(2, 1e6, 1e-6),
                rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]})
    cfg = Qwen2_5_VLConfig(
        text_config=text, vocab_size=VOCAB, hidden_size=256,
        vision_config=dict(depth=2, hidden_size=160, num_heads=2, intermediate_size=96,
                           out_hidden_size=256, patch_size=14, temporal_patch_size=2,
                           spatial_merge_size=2, window_size=112, fullatt_block_indexes=[1]),
        image_token_id=ids["<|image_pad|>"], video_token_id=ids["<|video_pad|>"],
        vision_start_token_id=ids["<|vision_start|>"])
    torch.manual_seed(0)
    model = Qwen2_5_VLForConditionalGeneration(cfg)
    with torch.no_grad():           # norm weights off 1, so the final norm shows
        for name, p in model.named_parameters():
            if name.endswith("norm.weight") or "layernorm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    path = tmp_path_factory.mktemp("qwen_vl")
    model.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaModel
    torch.manual_seed(1)
    model = LlamaModel(LlamaConfig(**_text_config(3, 5e5, 1e-5)))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape))
    path = tmp_path_factory.mktemp("llama")
    model.save_pretrained(path)
    return path


def test_saved_names_are_the_references(qwen_dir, llama_dir):
    from safetensors import safe_open
    with safe_open(str(qwen_dir / "model.safetensors"), "pt") as f:
        qwen = set(f.keys())
    with safe_open(str(llama_dir / "model.safetensors"), "pt") as f:
        llama = set(f.keys())
    assert "model.layers.0.self_attn.q_proj.weight" in qwen
    assert "visual.blocks.0.attn.qkv.weight" in qwen and "model.embed_tokens.weight" in qwen
    assert not any(k.startswith("model.language_model.") for k in qwen)
    assert "layers.0.self_attn.q_proj.weight" in llama and "norm.weight" in llama


def test_qwen_transformers_matches_native(qwen_dir):
    tok = StubQwenTokenizer(VOCAB)
    native = TQ.QwenImagePipeline(device="cpu", dtype=torch.float32)
    native.fetch_text_encoder(str(qwen_dir / "model.safetensors"), tok)
    hf = TQ.QwenImagePipeline(device="cpu", dtype=torch.float32)
    hf.fetch_text_encoder(str(qwen_dir), tok, backend="transformers")
    for prompt in PROMPTS:
        (e_n, m_n), (e_h, m_h) = native.encode_prompt(prompt), hf.encode_prompt(prompt)
        assert e_h.shape == e_n.shape and e_h.dtype == torch.float32
        assert torch.equal(m_h, m_n)
        assert _rel(e_h, e_n) < TOL_F32, _rel(e_h, e_n)
    with pytest.raises(RuntimeError, match="native Qwen2.5-VL"):
        hf.encode_prompt_edit("make it blue", [None])


def test_qwen_jax_fallback_refuses_the_directory(qwen_dir, monkeypatch):
    """JAX's backend='transformers' reaches `AutoModelForCausalLM`, which
    has no mapping for a Qwen2.5-VL configuration."""
    import transformers
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: StubQwenTokenizer(VOCAB)))
    with pytest.raises(ValueError, match="Qwen2_5_VLConfig"):
        JQ.QwenImagePipeline().fetch_text_encoder(str(qwen_dir), "tok",
                                                  backend="transformers")


@pytest.fixture(scope="module")
def llama_encodings(llama_dir):
    """(native, transformers) encodings of PROMPTS by the port, fp32."""
    tok = TH.StubLlamaTokenizer(VOCAB)
    out = {}
    for backend, path in (("native", str(llama_dir / "model.safetensors")),
                          ("transformers", str(llama_dir))):
        pipe = TH.HunyuanVideoPipeline(device="cpu", dtype=torch.float32)
        pipe.fetch_llm(path, tok, backend=backend)
        out[backend] = [pipe.llm(p) for p in PROMPTS]
    return out


def test_llama_transformers_matches_native(llama_encodings):
    for (e_n, m_n), (e_h, m_h) in zip(llama_encodings["native"],
                                      llama_encodings["transformers"]):
        assert e_n.shape == (1, 256, 256) and torch.equal(m_h, m_n)
        assert _rel(e_h, e_n) < TOL_F32, _rel(e_h, e_n)


def test_llama_jax_fallback_takes_another_layer(llama_dir, llama_encodings, monkeypatch):
    """JAX's backend='transformers' returns `last_hidden_state`: all three
    layers and the final norm, not layer 1 without it. Its rows equal HF's
    last hidden state (JAX loads the model in fp16: within 5e-3), and lie
    far from the native layer's (relative L2 25.0 and 26.3; held above
    0.5)."""
    import transformers
    tok = TH.StubLlamaTokenizer(VOCAB)

    def torch_tok(*args, return_tensors=None, **kw):
        return {k: torch.from_numpy(v) for k, v in tok(*args, **kw).items()}
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: torch_tok))
    jp = JH.HunyuanVideoPipeline(dtype=np.float32)
    jp.fetch_llm(str(llama_dir), "tok", backend="transformers")
    model = transformers.LlamaModel.from_pretrained(str(llama_dir)).eval()
    for prompt, (e_n, m_n) in zip(PROMPTS, llama_encodings["native"]):
        j_emb, j_mask = jp.llm(prompt)
        np.testing.assert_array_equal(np.asarray(j_mask), m_n.numpy())
        ids = tok(TH.PROMPT_TEMPLATE.format(prompt), max_length=TH.CROP_START + 256)
        with torch.no_grad():
            last = model(input_ids=torch.from_numpy(ids["input_ids"]),
                         attention_mask=torch.from_numpy(ids["attention_mask"])
                         ).last_hidden_state[:, TH.CROP_START:]
        j_emb = torch.from_numpy(np.array(j_emb, np.float32))
        assert _rel(j_emb, last) < 5e-3, _rel(j_emb, last)
        diff = _rel(j_emb, e_n)
        print(f"JAX fallback against the native layer, {prompt!r}: {diff:.4f}")
        assert diff > 0.5, diff
