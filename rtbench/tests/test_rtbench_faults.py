"""Each fault a cell can have, planted underneath the timed path of a
tiny run, turns ``correct`` false: a frame that returns its state
unchanged (rendered at the previous frame's camera and key), half of the
batch left out (half the samples, the mean over the rest; for primary
frames half the rows never rendered), and an answer altered where it is
produced (one block of pixels changed). The cells run on one card, so
none has an exchange between chips to leave out."""

import pytest

from rtbench import spec, system

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _stale(monkeypatch):
    orig = system.Frames.frame
    last = {}

    def frame(self, *inputs):
        prev = last.get("inputs", inputs)
        last["inputs"] = inputs
        return orig(self, *prev)

    monkeypatch.setattr(system.Frames, "frame", frame)


def _half(monkeypatch):
    orig = system.Frames.frame

    def frame(self, *inputs):
        if not self.static:
            image = orig(self, *inputs)
            image[image.shape[0] // 2:] = 0
            return image
        keep = self.static
        i = {"path_traced": 1, "ao": 0}[self.kind]  # the samples among the static arguments
        self.static = tuple(v // 2 if j == i else v for j, v in enumerate(keep))
        try:
            return orig(self, *inputs)
        finally:
            self.static = keep

    monkeypatch.setattr(system.Frames, "frame", frame)


def _altered(monkeypatch):
    orig = system.Frames.frame

    def frame(self, *inputs):
        image = orig(self, *inputs)
        image[8:16, 8:16] = image[8:16, 8:16] // 2 + 64
        return image

    monkeypatch.setattr(system.Frames, "frame", frame)


FAULTS = {"stale_state": _stale, "half_the_batch": _half, "altered_answer": _altered}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_run, cell):
    rc, result, _, err = tiny_run(cell)
    assert rc == 0 and result["correct"] is True, err


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_turns_correct_false(tiny_run, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    rc, result, _, err = tiny_run(cell)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1
