"""The port's training data against the JAX package's, and the two CLIs on
checkpoint files.

- `UnifiedDataset` over CSV/JSON/JSONL metadata of a few frames that the
  port's `data/video.py` writes here: the same arrays in both packages
  (the JAX package hands PIL images on, the port uint8 arrays).
- The latent cache: a cache written by either package loads in the other;
  `CachedLatentDataset` order and `repeat`; `launch_data_process_task`'s
  per-process folders.
- `infer_ditto --dit_path a|b --vae_path --t5_path --tokenizer_path` on
  smoke-size files gives the frames of the pipeline they were written
  from; `train --task data_process`, then `--cache_path`, gives the losses
  of training from the dataset directly. The files hold a DiT of dim 256
  (2 heads of 128, so detection gives the smoke widths) with `text_dim`
  4096 and `freq_dim` 256 (detection keeps those defaults), a 4096-wide
  two-layer umT5 and the 16-wide z=4 VAE, monkeypatched over the module
  level `UMT5_XXL`/`WAN21_VAE` that `from_pretrained` builds.
"""
import json
import os

import numpy as np
import pytest
import torch

from video_styler_tpu.trainers import latent_cache as JL
from video_styler_tpu.trainers import unified_dataset as JU

import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
import video_styler_tpu_torch.models.wan_vae as TVAE
import video_styler_tpu_torch.pipelines.wan_video as TW
from video_styler_tpu_torch.data.video import VideoData, save_video
from video_styler_tpu_torch.trainers import latent_cache as TL
from video_styler_tpu_torch.trainers import unified_dataset as TU
from video_styler_tpu_torch.utils.convert import save_release_files

from test_torch_pipeline import cpu_share  # noqa: F401


def _clip(seed, frames=7, h=40, w=56):
    """A smooth uint8 clip that drifts with time."""
    t = np.arange(frames, dtype=np.float32)[:, None, None, None]
    y = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    c = np.array([0.0, 0.4, 0.8], np.float32)[None, None, None, :]
    return (127.5 + 120 * np.sin(4 * x + 3 * y * (1 + c) + 0.5 * t + seed)).astype(np.uint8)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two clips, a PNG, and the same two rows as CSV, JSON and JSONL."""
    d = tmp_path_factory.mktemp("data")
    for i in (0, 1):
        save_video(_clip(i), str(d / f"clip{i}.mp4"), fps=8)
    from PIL import Image
    Image.fromarray(_clip(2, frames=1, h=45, w=61)[0]).save(str(d / "still.png"))
    rows = [{"video": "clip0.mp4", "vace_video": "clip1.mp4", "prompt": "make it a watercolor"},
            {"video": "clip1.mp4", "vace_video": "", "prompt": "the city at night"}]
    with open(d / "metadata.csv", "w") as f:
        f.write("video,vace_video,prompt\n")
        for r in rows:
            f.write(f"{r['video']},{r['vace_video']},{r['prompt']}\n")
    (d / "metadata.json").write_text(json.dumps({"data": rows}))
    (d / "metadata.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return d


def _same(port_value, jax_value):
    if isinstance(jax_value, list):
        assert isinstance(port_value, list) and len(port_value) == len(jax_value)
        for p, j in zip(port_value, jax_value):
            _same(p, j)
    elif hasattr(jax_value, "size") and hasattr(jax_value, "mode"):  # a PIL image
        assert port_value.dtype == np.uint8
        np.testing.assert_array_equal(port_value, np.asarray(jax_value.convert("RGB")))
    else:
        assert port_value == jax_value


@pytest.mark.parametrize("meta", ["metadata.csv", "metadata.json", "metadata.jsonl"])
def test_unified_dataset_matches_jax(data_dir, meta):
    base = str(data_dir)
    kw = dict(base_path=base, metadata_path=os.path.join(base, meta), repeat=2,
              data_file_keys=("video", "vace_video"))
    jd = JU.UnifiedDataset(**kw, main_data_operator=JU.UnifiedDataset.default_video_operator(
        base, num_frames=5, height=32, width=48))
    td = TU.UnifiedDataset(**kw, main_data_operator=TU.UnifiedDataset.default_video_operator(
        base, num_frames=5, height=32, width=48))
    assert len(td) == len(jd) == 4
    assert td.shuffled_indices(3) == jd.shuffled_indices(3)
    for i in range(len(td)):
        t, j = td[i], jd[i]
        assert t.keys() == j.keys()
        for k in j:
            _same(t[k], j[k])
        assert len(t["video"]) == 5 and t["video"][0].shape == (32, 48, 3)


def test_operators_match_jax(data_dir):
    """Bucketing without a fixed size (max_pixels, /16 snapping), the
    image loader, and routing by extension."""
    base = str(data_dir)

    def chain(U):
        return U.RouteByExtension({
            ".mp4|.mov": U.ToAbsolutePath(base) >> U.LoadVideo(num_frames=6)
            >> U.ImageCropAndResize(max_pixels=32 * 40),
            ".png|.jpg": U.ToAbsolutePath(base) >> U.LoadImage()
            >> U.ImageCropAndResize(max_pixels=40 * 50)})

    tc, jc = chain(TU), chain(JU)
    for name in ("clip0.mp4", "still.png"):
        _same(tc(name), jc(name))
    assert len(tc("clip0.mp4")) == 5          # 4k+1 frames of the 7
    assert tc("still.png").shape == (32, 48, 3)
    with pytest.raises(ValueError, match="no route"):
        tc("notes.txt")


def test_latent_cache_loads_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    latents = torch.from_numpy(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32))
    # the port writes bf16 tensors as fp32 arrays (exact), drops None
    TL.save_cached_sample(str(tmp_path / "0"), 0, {
        "latents": latents.to(torch.bfloat16), "context": context,
        "vace_context": None, "prompt": "a watercolor", "steps": 3})
    JL.save_cached_sample(str(tmp_path / "1"), 1, {
        "latents": latents.numpy(), "context": context.numpy(), "prompt": "night",
        "scale": 0.5})
    port_in_jax = JL.load_cached_sample(str(tmp_path / "0" / "0.npz"))
    assert port_in_jax["latents"].dtype == np.float32
    np.testing.assert_array_equal(port_in_jax["latents"],
                                  latents.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(port_in_jax["context"], context.numpy())
    assert (port_in_jax["prompt"], port_in_jax["steps"]) == ("a watercolor", 3)
    assert "vace_context" not in port_in_jax
    jax_in_port = TL.load_cached_sample(str(tmp_path / "1" / "1.npz"))
    np.testing.assert_array_equal(jax_in_port["latents"], latents.numpy())
    assert (jax_in_port["prompt"], jax_in_port["scale"]) == ("night", 0.5)
    tds, jds = TL.CachedLatentDataset(str(tmp_path)), JL.CachedLatentDataset(str(tmp_path))
    assert tds.paths == jds.paths and len(tds) == len(jds) == 2


def test_cached_dataset_order_and_repeat(tmp_path):
    for shard, idx in ((1, 4), (0, 2), (0, 0), (1, 3)):
        TL.save_cached_sample(str(tmp_path / str(shard)), idx,
                              {"latents": np.full((2,), idx, np.float32)})
    ds = TL.CachedLatentDataset(str(tmp_path), repeat=3)
    assert [os.path.relpath(p, tmp_path) for p in ds.paths] == [
        "0/0.npz", "0/2.npz", "1/3.npz", "1/4.npz"]
    assert len(ds) == 12 and ds.load_from_cache
    assert [int(ds[i]["latents"][0]) for i in range(len(ds))] == [0, 2, 3, 4] * 3
    assert JL.CachedLatentDataset(str(tmp_path), repeat=3).paths == ds.paths
    with pytest.raises(FileNotFoundError):
        TL.CachedLatentDataset(str(tmp_path / "empty"))


def test_data_process_task_matches_jax(tmp_path):
    rows = [{"x": float(i), "prompt": f"p{i}"} for i in range(5)]

    def fn(row):
        return None if row["x"] == 3 else {"v": np.arange(3, dtype=np.float32) * row["x"],
                                           "prompt": row["prompt"]}

    for process_index in (0, 1):
        t = TL.launch_data_process_task(rows, fn, str(tmp_path / "t"), process_index, 2)
        j = JL.launch_data_process_task(rows, fn, str(tmp_path / "j"), process_index, 2)
        assert [os.path.relpath(p, tmp_path / "t") for p in t] == \
            [os.path.relpath(p, tmp_path / "j") for p in j]
        for a, b in zip(t, j):
            ta, jb = TL.load_cached_sample(a), JL.load_cached_sample(b)
            np.testing.assert_array_equal(ta["v"], jb["v"])
            assert ta["prompt"] == jb["prompt"]
    assert sorted(os.listdir(tmp_path / "t" / "1")) == ["1.npz"]


# ---------------------------------------------------------------- the CLIs

DIT = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2, num_layers=2)
VACE = dict(vace_layers=(0, 1), vace_in_dim=72, dim=256, num_heads=2, ffn_dim=512)
T5 = dict(vocab=64, dim=4096, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=2,
          num_buckets=8)
VAE = dict(dim=16, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
           latent_mean=(0.0,) * 4, latent_std=(1.0,) * 4)


def _save_tokenizer(folder):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    words = "make it a watercolor painting of the city at night".split()
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            eos_token="</s>").save_pretrained(folder)


@pytest.fixture
def release(tmp_path, monkeypatch):
    """A smoke-size pipeline from seed 0 and its files in the release
    layout, with the tokenizer beside them; the CLIs build the small umT5
    and VAE."""
    monkeypatch.setattr(TW, "UMT5_XXL", TT.T5Config(**T5))
    monkeypatch.setattr(TVAE, "WAN21_VAE", TVAE.WanVAEConfig(**VAE))
    from transformers import AutoTokenizer
    folder = tmp_path / "Wan2.1-VACE-14B"
    folder.mkdir()
    _save_tokenizer(str(folder / "google" / "umt5-xxl"))
    pipe = TW.WanVideoPipeline.from_configs(
        TD.WanDiTConfig(**DIT), TV.VaceConfig(**VACE), TT.T5Config(**T5),
        TVAE.WanVAEConfig(**VAE), AutoTokenizer.from_pretrained(
            str(folder / "google" / "umt5-xxl")), seed=0, device="cpu")
    paths = save_release_files(pipe, str(folder), n_shards=2)
    return pipe, paths


def test_infer_cli_from_checkpoint_files(tmp_path, release):
    from video_styler_tpu_torch.infer_ditto import main
    pipe, paths = release
    assert len(paths["dit"]) == 2
    clip = tmp_path / "in.mp4"
    save_video(_clip(0, frames=6), str(clip), fps=8)
    out = tmp_path / "edit.mp4"
    frames = main(["--prompt", "make it a watercolor", "--device", "cpu",
                   "--dit_path", "|".join(paths["dit"]), "--vae_path", paths["vae"],
                   "--t5_path", paths["t5"], "--tokenizer_path",
                   os.path.join(os.path.dirname(paths["t5"]), "google", "umt5-xxl"),
                   "--input_video", str(clip),
                   "--num_frames", "5", "--height", "32", "--width", "32",
                   "--num_inference_steps", "2", "--output_path", str(out)])
    vd = VideoData(str(clip), height=32, width=32)
    want = pipe(prompt="make it a watercolor", vace_video=np.stack([vd[i] for i in range(5)]),
                num_frames=5, height=32, width=32, seed=42, cfg_scale=5.0,
                num_inference_steps=2, tiled=True)
    assert frames.shape == (5, 32, 32, 3) and out.exists()
    np.testing.assert_array_equal(frames, want)


def test_train_cli_data_process_then_cache(tmp_path, release, data_dir):
    from video_styler_tpu_torch.train import main
    _, paths = release
    # no --tokenizer_path: the tokenizer is found beside the checkpoints
    common = ["--device", "cpu", "--dit_path", "|".join(paths["dit"]),
              "--vae_path", paths["vae"], "--t5_path", paths["t5"],
              "--height", "32", "--width", "32", "--num_frames", "5",
              "--lora_base_model", "vace", "--lora_rank", "4", "--max_steps", "2"]
    data = ["--dataset_base_path", str(data_dir), "--dataset_metadata_path",
            str(data_dir / "metadata.csv"), "--extra_inputs", "vace_video"]
    direct = main(common + data + ["--output_path", str(tmp_path / "direct")])
    assert direct["steps"] == 2 and all(np.isfinite(direct["losses"]))
    cache = str(tmp_path / "cache")
    written = main(common + data + ["--task", "data_process", "--output_path", cache])
    assert [os.path.relpath(w, cache) for w in written["written"]] == ["0/0.npz", "0/1.npz"]
    sample = TL.load_cached_sample(written["written"][0])
    assert sample["latents"].shape == (1, 4, 2, 4, 4)
    assert sample["context"].shape == (1, 512, 4096)
    assert sample["vace_context"].shape == (1, 72, 2, 4, 4)
    cached = main(common + ["--cache_path", cache, "--output_path", str(tmp_path / "cached")])
    assert cached["losses"] == direct["losses"]
