"""The port's terminal viewer (radish_pt_tpu_torch/viewer.py): a
scripted REPL over a CPU ``Renderer`` at 16x16."""

import io
import os

import pytest

torch = pytest.importorskip("torch")

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_scripted_repl(tmp_path, monkeypatch, capsys):
    """``t`` (the direct tracer), ``n`` (the Gaussian denoiser), ``r``
    (reset), ``x`` (save and quit), two frames a burst: each command's
    burst renders, the stats follow the settings, and the files appear."""
    from radish_pt_tpu_torch import viewer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("t\nn\nr\nx\n"))
    assert viewer.main([os.path.join(SCENES, "cornell_box.txt"), "--res", "16", "16",
                        "--device", "cpu", "--spp-per-step", "2"]) == 0
    out = capsys.readouterr().out
    stats = [line for line in out.splitlines() if "| tracer" in line]
    assert "iter 0 | tracer pt | denoiser none" in stats[0]
    assert "iter 2 | tracer direct | denoiser none" in stats[1]
    assert "iter 4 | tracer direct | denoiser gaussian" in stats[2]
    assert "iter 2 | tracer direct | denoiser gaussian" in stats[3]  # reset, one burst
    assert out.count("2 frames,") == 4 and "[saved " in out
    assert (tmp_path / "preview.png").read_bytes()[:4] == b"\x89PNG"
    assert any(p.name.startswith("cornell.") and p.name.endswith("samp.png")
               for p in tmp_path.iterdir())
