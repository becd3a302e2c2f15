"""The twin's labeler-core tier (``tests/test_lm_core.py``) held against
the port: ``lm/labeler.py`` ``Merge``/``Empty`` and ``lm/labels.py``'s
atomic, churn-free writer. Every case runs the same seeded input through
the twin and the port and wants the same label map, the same bytes on
disk and the same counter moves; label keys are translated
``google.com/tpu.`` -> ``nvidia.com/gpu.`` where a key carries one."""

import os
import stat

import numpy as np
import pytest

from gpu_feature_discovery_tpu import lm as twin_lm
from gpu_feature_discovery_tpu.lm import labels as twin_labels
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu_torch import lm as port_lm
from gpu_feature_discovery_tpu_torch.lm import labels as port_labels
from gpu_feature_discovery_tpu_torch.obs import metrics as port_metrics

SIDES = {
    "twin": (twin_lm, twin_labels, twin_metrics),
    "port": (port_lm, port_labels, port_metrics),
}


def _seeded_maps(seed, n_maps=4, n_keys=6):
    """Label maps drawn from a seed: overlapping keys, so merge order
    decides every overlap."""
    rng = np.random.default_rng(seed)
    keys = [f"nvidia.com/gpu.k{i}" for i in range(n_keys)]
    maps = []
    for _ in range(n_maps):
        chosen = rng.choice(n_keys, size=int(rng.integers(0, n_keys + 1)), replace=False)
        maps.append({keys[i]: str(int(rng.integers(0, 100))) for i in sorted(chosen)})
    return maps


class _Static:
    def __init__(self, labels_cls, labels):
        self._labels = labels_cls(labels)

    def labels(self):
        return self._labels


class _Failing:
    def labels(self):
        raise RuntimeError("probe failed")


def test_labels_is_a_labeler():
    for lm, _, _ in SIDES.values():
        labels = lm.Labels({"a": "1"})
        assert labels.labels() is labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_later_labels_win(seed):
    maps = _seeded_maps(seed)
    merged = {}
    for name, (lm, _, _) in SIDES.items():
        parts = [_Static(lm.Labels, m) for m in maps]
        parts.insert(2, lm.Empty())
        merged[name] = dict(lm.Merge(*parts).labels())
    expected = {}
    for m in maps:
        expected.update(m)
    assert merged["port"] == merged["twin"] == expected


def test_merge_of_nothing_is_empty():
    assert dict(port_lm.Merge().labels()) == dict(twin_lm.Merge().labels()) == {}


def test_merge_propagates_errors():
    for lm, _, _ in SIDES.values():
        with pytest.raises(RuntimeError, match="probe failed"):
            lm.Merge(_Static(lm.Labels, {"a": "1"}), _Failing()).labels()


def test_write_to_file_format(tmp_path):
    texts = {}
    for name, (lm, _, _) in SIDES.items():
        out = tmp_path / name / "tfd"
        out.parent.mkdir()
        lm.Labels({"nvidia.com/gpu.count": "4",
                   "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}).write_to_file(str(out))
        texts[name] = out.read_text()
    assert texts["port"] == texts["twin"]
    assert sorted(texts["port"].splitlines()) == [
        "nvidia.com/gpu.count=4",
        "nvidia.com/gpu.product=NVIDIA-H100-80GB-HBM3",
    ]


def test_write_is_atomic_and_staged(tmp_path):
    for name, (lm, _, _) in SIDES.items():
        out = tmp_path / name / "tfd"
        out.parent.mkdir()
        lm.Labels({"k": "v1"}).write_to_file(str(out))
        lm.Labels({"k": "v2"}).write_to_file(str(out))
        assert out.read_text() == "k=v2\n"
        staging = out.parent / "tfd-tmp"
        assert staging.is_dir() and list(staging.iterdir()) == []


def test_write_sets_mode_0644(tmp_path):
    for name, (lm, _, _) in SIDES.items():
        out = tmp_path / f"{name}-tfd"
        lm.Labels({"k": "v"}).write_to_file(str(out))
        assert stat.S_IMODE(os.stat(out).st_mode) == 0o644


def test_empty_path_writes_stdout(capsys):
    outs = {}
    for name, (lm, _, _) in SIDES.items():
        lm.Labels({"k": "v", "a": "b"}).write_to_file("")
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["twin"]
    assert sorted(outs["port"].splitlines()) == ["a=b", "k=v"]


def test_remove_output_file_cleans_staging(tmp_path):
    for name, (lm, labels_mod, _) in SIDES.items():
        out = tmp_path / name / "tfd"
        out.parent.mkdir()
        lm.Labels({"k": "v"}).write_to_file(str(out))
        labels_mod.remove_output_file(str(out))
        assert not out.exists()
        assert not (out.parent / "tfd-tmp").exists()


def test_churn_skip_needs_no_disk_read_after_first_write(tmp_path, monkeypatch):
    def bomb(path, contents):
        raise AssertionError("steady-state churn check read the disk")

    moved = {}
    for name, (lm, labels_mod, metrics) in SIDES.items():
        out = tmp_path / f"{name}-tfd"
        lm.Labels({"k": "v"}).write_to_file(str(out))
        monkeypatch.setattr(labels_mod, "_file_contents_equal", bomb)
        before = metrics.LABEL_WRITE_SKIPS.value()
        for _ in range(3):
            lm.Labels({"k": "v"}).write_to_file(str(out))
        moved[name] = metrics.LABEL_WRITE_SKIPS.value() - before
        assert out.read_text() == "k=v\n"
    assert moved == {"twin": 3, "port": 3}


def test_out_of_band_edit_still_triggers_rewrite(tmp_path):
    for name, (lm, _, _) in SIDES.items():
        out = tmp_path / f"{name}-tfd"
        lm.Labels({"k": "v"}).write_to_file(str(out))
        lm.Labels({"k": "v"}).write_to_file(str(out))  # the cached skip
        out.write_text("tampered=true\n")
        lm.Labels({"k": "v"}).write_to_file(str(out))
        assert out.read_text() == "k=v\n"


def test_out_of_band_touch_with_identical_content_reseeds_the_cache(tmp_path):
    writes = {}
    for name, (lm, labels_mod, metrics) in SIDES.items():
        out = tmp_path / f"{name}-tfd"
        lm.Labels({"k": "v"}).write_to_file(str(out))
        out.write_text("k=v\n")  # identical bytes, a new inode and mtime
        before = metrics.LABEL_WRITES.value()
        lm.Labels({"k": "v"}).write_to_file(str(out))
        writes[name] = metrics.LABEL_WRITES.value() - before
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(labels_mod, "_file_contents_equal",
                       lambda *a: (_ for _ in ()).throw(AssertionError("disk read")))
            lm.Labels({"k": "v"}).write_to_file(str(out))
        assert out.read_text() == "k=v\n"
    assert writes == {"twin": 0, "port": 0}


def test_remove_output_file_forgets_the_write_cache(tmp_path):
    for name, (lm, labels_mod, _) in SIDES.items():
        out = tmp_path / f"{name}-tfd"
        lm.Labels({"k": "v"}).write_to_file(str(out))
        labels_mod.remove_output_file(str(out))
        assert str(out) not in labels_mod._write_cache
        lm.Labels({"k": "v"}).write_to_file(str(out))
        assert out.read_text() == "k=v\n"
