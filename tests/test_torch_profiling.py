"""utils/profiling.py of the port: profile_trace writes a Chrome trace of its
block with torch.profiler, summarize_trace reads the newest one back as a
per-op table. On the CPU the table holds the CPU's operators (the card's
kernels when the trace has them, which only a run on the card gives)."""

import os

import numpy as np
import pytest
import torch

from nope_nerf_torch.config import load_config
from nope_nerf_torch.data import SceneData, batch_for_frame, make_synthetic_scene
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
from nope_nerf_torch.utils.profiling import profile_trace, summarize_trace

torch.set_num_threads(2)


def _tiny_step():
    cfg = load_config(overrides={"model": {"hidden_dim": 32}, "rendering": {"num_points": 16},
                                 "training": {"n_training_points": 32},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=24, w=32)).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, 4)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    trainer = Trainer(cfg, mc)
    return lambda: trainer.step(state, batch_for_frame(scene, 1, ref_idx=2), 0, 10000)


def test_trace_of_one_train_step_reads_back(tmp_path):
    step = _tiny_step()
    step()                                   # warm-up outside the trace
    with profile_trace(str(tmp_path)):
        step()
        step()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    rows = summarize_trace(str(tmp_path), steps=2, top=50)
    assert rows and len(rows) <= 50
    ms = [r[0] for r in rows]
    assert ms == sorted(ms, reverse=True) and all(np.isfinite(ms))
    names = {r[2] for r in rows}
    assert any(n in names for n in ("aten::mm", "aten::addmm", "aten::bmm"))
    per_step = {r[2]: r[1] for r in summarize_trace(str(tmp_path), steps=1, top=50)}
    for t, c, name in rows:                  # steps=2 halves the counts and times
        assert c == pytest.approx(per_step[name] / 2)


def test_no_log_dir_is_a_no_op_and_an_empty_dir_raises(tmp_path):
    with profile_trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
    with pytest.raises(FileNotFoundError, match="no trace files"):
        summarize_trace(str(tmp_path))
