"""``mfu.train`` in a training cell on four cards, read on rank 0's card
(its share of the global batch over its stretch: a card's share of the
peak): a metric of its own because such a cell reports
``train_frames_per_s_x4``, not the one-card rate."""

from harness import files

_one_card = files.reader("mfu.train")
SUBMODULES, KERNELS, read = _one_card.SUBMODULES, _one_card.KERNELS, _one_card.read
