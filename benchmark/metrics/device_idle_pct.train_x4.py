"""``device_idle_pct.train`` in a training cell on four cards, read on rank
0's card: a metric of its own because such a cell reports
``train_frames_per_s_x4``, not the one-card rate."""

from harness import files

_one_card = files.reader("device_idle_pct.train")
SUBMODULES, KERNELS, read = _one_card.SUBMODULES, _one_card.KERNELS, _one_card.read
