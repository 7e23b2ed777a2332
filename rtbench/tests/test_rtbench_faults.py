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
    """Traffic that draws samples renders half of them on the port's side;
    a primary frame loses its lower half of rows."""
    orig_init, orig_frame = system.Frames.__init__, system.Frames.frame

    def init(self, config, traffic, *rest):
        self.halved = "samples" in traffic
        if self.halved:
            traffic = dict(traffic, samples=traffic["samples"] // 2)
        orig_init(self, config, traffic, *rest)

    def frame(self, *inputs):
        image = orig_frame(self, *inputs)
        if not self.halved:
            image[image.shape[0] // 2:] = 0
        return image

    monkeypatch.setattr(system.Frames, "__init__", init)
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
