"""The port's ``Trainer.fit`` with its checkpoints and resume, the
checkpoint manager, the refusal of a multi-device mesh, and the training
CLI, on the CPU.

A resumed run repeats the uninterrupted run's next step exactly: the same
process, the same CPU kernels, the same draws.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from segmentation_factory_tpu_torch import config
from segmentation_factory_tpu_torch.checkpoint import CheckpointManager
from segmentation_factory_tpu_torch.data.datasets import Synthetic
from segmentation_factory_tpu_torch.engine import create_optimizer
from segmentation_factory_tpu_torch.engine import loop as tloop
from segmentation_factory_tpu_torch.schedule import create_schedule

from _torch_port import two_torch_threads  # noqa: F401  (autouse)
from _torch_trainer import tiny_cfg, tiny_datasets

REPO = Path(__file__).resolve().parents[1]


def test_fit_then_resume_repeats_the_next_step(tmp_path):
    """One epoch (2 steps) of ``fit`` saves a checkpoint; a second Trainer
    on the same output directory resumes at step 2 with the same parameters
    and optimizer state, and its next step equals the first Trainer's."""
    cfg = tiny_cfg(config, tmp_path)
    a = tloop.Trainer(cfg, *tiny_datasets(Synthetic), device="cpu")
    best = a.fit(1)
    assert a.step == 2 and a.ckpt.latest_step() == 2 == a.ckpt.best_step()
    lines = [json.loads(s) for s in open(a.results_path)]
    assert len(lines) == 1 and math.isfinite(lines[0]["train_loss"])
    assert (tmp_path / "model.txt").exists() and (tmp_path / "logs" / "scalars.jsonl").exists()

    b = tloop.Trainer(cfg, *tiny_datasets(Synthetic), device="cpu")
    assert b.step == 2 and b.best == best
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=0)
    for k in ("mu", "nu", "count"):
        torch.testing.assert_close(getattr(b.optimizer, k), getattr(a.optimizer, k), rtol=0,
                                   atol=0)

    a.train_loader.set_epoch(1)
    batch = next(iter(a.train_loader))
    ma, mb = a.train_step(batch), b.train_step(batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0, msg=name)
    assert b.fit(1) == best  # nothing left to train: the run is complete


def test_checkpoint_manager_keeps_the_best_two(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = create_optimizer("adamw", create_schedule("cosine", 1e-3, total_steps=10),
                           params=model.named_parameters())
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.latest_step() is None and mngr.restore(model) == (None, {})
    for step, miou in ((1, 5.0), (2, 9.0), (3, 7.0), (4, 7.0)):
        with torch.no_grad():
            model.weight.fill_(step)
        mngr.save(step, model, opt, {"mIoU": miou})
    assert mngr.steps() == [2, 4] and mngr.best_step() == 2 and mngr.latest_step() == 4
    assert mngr.restore(model, opt, step=2) == (2, {"mIoU": 9.0})
    assert float(model.weight[0, 0].detach()) == 2.0
    other = torch.nn.Linear(3, 2)
    opt2 = create_optimizer("adamw", create_schedule("cosine", 1e-3, total_steps=10),
                            params=[("w", other.weight), ("b", other.bias)])
    with pytest.raises(ValueError, match="other parameters"):
        opt2.load_state_dict(opt.state_dict())


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["mesh", "mesh_tp"])
def test_trainer_refuses_unported_options(tmp_path, mesh):
    """A mesh of more than one device (data or tensor parallel) is the one
    option the port does not run; one device, ``(1, 1)``, runs."""
    cfg = tiny_cfg(config, tmp_path)
    cfg.mesh_shape = mesh
    with pytest.raises(NotImplementedError, match="not ported"):
        tloop.Trainer(cfg, *tiny_datasets(Synthetic), device="cpu")


def test_cli_trains_on_the_cpu(tmp_path):
    """``python -m segmentation_factory_tpu_torch.train`` on the synthetic
    set (64 images of 512², cropped to 32²): one epoch of 8 steps, an eval,
    a checkpoint; then ``--eval`` resumes it."""
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    args = [sys.executable, "-m", "segmentation_factory_tpu_torch.train", "--dataset",
            "synthetic", "--backbone", "mit_b0", "--img-size", "32", "--batch-size", "8",
            "--epochs", "1", "--warmup-steps", "1", "--workers", "2", "--print-freq", "4",
            "--output-dir", str(out), "--device", "cpu"]
    res = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (line,) = [json.loads(s) for s in open(out / "results.jsonl")]
    assert line["steps"] == 8 and math.isfinite(line["train_loss"]) and 0 <= line["mIoU"] <= 100
    assert sorted(os.listdir(out / "ckpt")) == ["step_8.pt"]
    assert json.loads((out / "config.json").read_text())["data"]["img_size"] == 32
    res = subprocess.run(args + ["--eval"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from step 8" in res.stdout
