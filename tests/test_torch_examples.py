"""The PyTorch/CUDA package's examples (``examples/torch_*``) run at tiny
sizes on the CPU (``--device cpu``): hello world, the MNIST MLP and the
converter -> K1 -> ViT loop, through the converter's Spark path (on the
conftest's ``spark_session``) and its path without Spark."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  REPO / "examples" / name / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hello_world_runs_on_the_cpu(tmp_path, capsys):
    hw = _load_example("torch_hello_world")
    batch = hw.main(f"file://{tmp_path}/hw", device="cpu")
    out = capsys.readouterr().out
    assert "row sample" in out and "torch batch" in out
    assert batch["image1"].device.type == "cpu" and batch["image1"].shape == (8, 128, 256, 3)
    assert batch["id"].tolist() == list(range(8))


def test_hello_world_command_line(tmp_path):
    out = subprocess.run([sys.executable, "examples/torch_hello_world/main.py", "--url",
                          f"file://{tmp_path}/hw", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "torch batch: (8, 128, 256, 3) torch.uint8 on cpu" in out.stdout


def test_mnist_example_learns(tmp_path):
    """Two epochs on 1,024 rows reach well above chance (the JAX example's
    test bar; chance is 0.1)."""
    mnist = _load_example("torch_mnist")
    images, labels = mnist.synthetic_mnist(1024)
    url = f"file://{tmp_path}/mnist"
    mnist.write_dataset(url, images, labels)
    result = mnist.train(url, epochs=2, batch_size=128, device="cpu", log=lambda _: None)
    assert result["steps"] == 16
    assert result["accuracy"] > 0.5 and result["samples_per_sec"] > 0


def test_spark_to_vit_without_spark(tmp_path):
    """The store written directly, opened as a converter: its loader's
    batches go through K1's plain version (CPU tensors) into ViT steps, and
    the loss falls."""
    example = _load_example("torch_spark_to_vit")
    converter = example.make_converter(f"file://{tmp_path}/store", 192, classes=4, image=16)
    assert len(converter) == 192 and converter.cache_dir_url == f"file://{tmp_path}/store"
    losses = example.train(converter, steps=15, batch_size=64, classes=4, image=16,
                           device="cpu", log=lambda _: None)
    assert len(losses) == 15 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]


def test_spark_to_vit_through_make_spark_converter(tmp_path, spark_session):
    """With a SparkSession the images go through ``make_spark_converter``
    (int32 pixels in the cached store), and train the same way."""
    example = _load_example("torch_spark_to_vit")
    images = np.concatenate([group for group, _ in example.synthetic_groups(128, 4, 16)])
    converter = example.make_converter(f"file://{tmp_path}/cache", 128, classes=4, image=16)
    try:
        assert len(converter) == 128
        assert converter.cache_dir_url.startswith(f"file://{tmp_path}/cache/")
        with converter.make_device_loader(batch_size=32, num_epochs=1, device="cpu",
                                          shuffle_row_groups=False) as loader:
            first = next(iter(loader))
        assert first["image"].shape == (32, 768)
        assert torch.equal(first["image"].to(torch.uint8),
                           torch.from_numpy(images[:32]))
        losses = example.train(converter, steps=8, batch_size=32, classes=4, image=16,
                               device="cpu", log=lambda _: None)
        assert np.isfinite(losses).all()
    finally:
        converter.delete()


def test_imagenet_example_trains_through_k1_on_the_cpu(tmp_path, monkeypatch):
    """The ResNet step with flips, crops and K1's plain version on CPU
    tensors; a small net (the stages patched) on 32-pixel images; the loss
    is finite and falls, and the loader's stall report covers the steps."""
    example = _load_example("torch_imagenet")
    from petastorm_tpu_torch.benchmark.imagenet_bench import write_synthetic_imagenet
    from petastorm_tpu_torch.models import resnet
    monkeypatch.setattr(resnet, "_RESNET50_STAGES", ((1, 8), (1, 16)))
    url = f"file://{tmp_path}/imagenet"
    write_synthetic_imagenet(url, 256, classes=4, image_size=32, rows_per_row_group=32)
    result = example.train(url, steps=24, batch_size=16, classes=4, device="cpu", workers=2,
                           log=lambda _: None)
    losses = result["losses"]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert result["stall_report"]["steps"] >= 24 and result["samples_per_sec"] > 0


def test_llm_tokens_example_trains_on_the_cpu(tmp_path):
    """NGram windows through ``DataLoader`` into the Llama step with the
    flash attention wrapper (its plain version on CPU tensors)."""
    example = _load_example("torch_llm_tokens")
    url = f"file://{tmp_path}/tokens"
    example.write_token_stream(url, 512, 64, rows_per_row_group=64)
    result = example.train(url, steps=10, batch_size=4, window=2, vocab=64, device="cpu",
                           log=lambda _: None)
    losses = result["losses"]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) and result["tokens_per_sec"] > 0


def test_long_context_example_on_two_cpu_gloo_ranks(tmp_path):
    """The command line on 2 spawned CPU ranks (ring attention, the flash
    local step's plain version): the script itself asserts that the loss
    fell."""
    out = subprocess.run([sys.executable, "examples/torch_long_context/main.py", "--url",
                          f"file://{tmp_path}/lc", "--chunks", "1024", "--vocab", "64",
                          "--window", "4", "--steps", "12", "--ranks", "2", "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("mesh dp1 x sp2")]
    assert line and "seq_len=256" in line[0]
    assert np.isfinite(float(line[0].split("final_loss=")[1].split()[0]))
