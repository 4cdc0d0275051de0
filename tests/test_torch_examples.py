"""The port's example scripts run on the CPU (``--device cpu``; each
defaults to ``cuda:0``) and print what they promise."""
import importlib.util
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart(capsys):
    _example("torch_quickstart.py").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "co-executed 1048576 work-items" in out and "cpu#1" in out


def test_concurrent_requests(capsys):
    _example("torch_concurrent_requests.py").main(
        ["--device", "cpu", "--requests", "4", "--n", "4096"])
    out = capsys.readouterr().out
    assert "4 concurrent requests on 2 units" in out
    assert "policy=work_stealing" in out


def test_coexec_benchmarks(capsys):
    _example("torch_coexec_benchmarks.py").main(
        ["--device", "cpu", "--n", "4096"])
    out = capsys.readouterr().out
    for name in ("taylor", "mandelbrot", "ray", "rap"):
        block = out.split(f"== {name} (4096 items, usm)\n")[1]
        lines = block.splitlines()[:4]
        assert [line.split(":")[0].strip() for line in lines] == [
            "static", "dyn16", "hguided", "work_stealing"], name
        assert all("packages, copies h2d=0 d2h=0" in line
                   for line in lines), name


@pytest.mark.parametrize("arch", ["h2o-danube3-4b", "whisper-medium",
                                  "xlstm-1.3b"])
def test_serve_lm(capsys, arch):
    _example("torch_serve_lm.py").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len",
         "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 device=cpu" in out
    assert "decode :" in out and "sample generation" in out


def test_hetero_train_with_a_crash(capsys, tmp_path):
    _example("torch_hetero_train.py").main(
        ["--device", "cpu", "--steps", "4", "--microbatches", "4",
         "--inject-crash-at", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "ran 4 steps (1 restarts" in out and "final loss" in out


def test_hetero_train_dry_run(capsys):
    _example("torch_hetero_train.py").main(["--device", "cpu", "--dry-run"])
    out = capsys.readouterr().out
    assert "[qwen3-0.6b × train_4k × card]" in out
    assert not torch.distributed.is_initialized()
