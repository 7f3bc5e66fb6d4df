"""The port's examples (``examples/torch_*.py``) run on the CPU at their
smallest sizes, in this process (each exposes ``main(argv)``; no subprocess
per example), and do what their JAX counterparts show: the quickstart's
shapes and half-lives, the stream's fixed-size decode state, both serving
routes' streams, the training driver's steps and checkpoint."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "long_context_stream", "serve_lm", "train_lm"])
def test_torch_example_runs_on_the_cpu(name, tmp_path, capsys):
    main = _example(name).main
    if name == "quickstart":
        out = main(["--device", "cpu", "--seq", "64"])
        assert out["y"].shape == (2, 64, 256) and out["logits"].shape == (1, 64, 512)
        assert out["half_lives"].shape == (8, 16) and bool((out["half_lives"] > 0).all())
        assert "token-relevance half-lives" in capsys.readouterr().out
    elif name == "long_context_stream":
        out = main(["--device", "cpu", "--tokens", "60", "--report-every", "20",
                    "--d-model", "32"])
        # the start and three reports: the same bytes, however long the stream
        assert len(out["state_bytes"]) == 4 and len(set(out["state_bytes"])) == 1
        assert bool(torch.isfinite(out["logits"]).all())
    elif name == "serve_lm":
        (colocated, _), (disagg, _) = main(["--device", "cpu", "--reduced", "--requests", "2",
                                            "--max-new", "2"])
        for streams in (colocated, disagg):      # {request id: tokens}
            assert sorted(streams) == [0, 1] and all(len(t) == 2 for t in streams.values())
    else:
        state = main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                      "--d-model", "32", "--layers", "1", "--nodes", "4",
                      "--ckpt-dir", str(tmp_path / "ckpt")])
        assert state["params"]["embed"]["embed"].shape[1] == 32
        assert any((tmp_path / "ckpt").iterdir())
        assert "[train] done" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # CUDA by default, with no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
