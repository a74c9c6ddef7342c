"""Operations and bytes of the work, and the chip's published peaks.

The counts come from the plain reference's own active sets and neighbour
pairs on the run's inputs (``reference.Ctx.counts``), so a roofline share
reads the same work whatever implements a layer. A conv's least time is
the larger of its operations over the bf16 tensor-core peak and its bytes
over the memory bandwidth, each input read once and each output written
once (the arithmetic of the port's ``chip_smoke.py`` bounds).
"""

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, F32, INDEX = 2, 4, 4      # bytes of an element


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def conv_bytes(n_in, n_out, cin, cout, kvol, esize=BF16, index_bytes=0):
    """The inputs (features and weights, in the compute dtype), any index
    tables, and the float32 output."""
    return n_in * cin * esize + index_bytes + kvol * cin * cout * esize + n_out * cout * F32


def conv_flops(cin, cout, hits):
    return 2 * cin * cout * hits


def conv_least_s(c: dict) -> float:
    """One sparse conv forward: 2*Cin*Cout per neighbour pair hit."""
    return least_s(conv_flops(c["cin"], c["cout"], c["hits"]),
                   conv_bytes(c["n_in"], c["n_out"], c["cin"], c["cout"], c["kvol"]))


def conv_dx_least_s(c: dict) -> float:
    """Its input gradient: the same pairs, the output gradient in, the
    input gradient out."""
    return least_s(conv_flops(c["cin"], c["cout"], c["hits"]),
                   conv_bytes(c["n_out"], c["n_in"], c["cout"], c["cin"], c["kvol"]))


def regather_least_s(c: dict) -> float:
    """The weight gradient's regather of the forward's columns: each
    active input row read once, each hit pair's row written once."""
    return (c["n_in"] + c["hits"]) * c["cin"] * BF16 / HBM_BYTES_PER_S


def sparse_convs(counts):
    return [c for c in counts if "hits" in c]


def forward_flops(counts) -> float:
    """The configuration's own arithmetic of one forward: sparse convs on
    their pairs, dense layers on their outputs, MLPs on their rows."""
    return float(sum(c["flops"] if "flops" in c else conv_flops(c["cin"], c["cout"], c["hits"])
                     for c in counts))


def train_flops(counts) -> float:
    """Forward, input gradient and weight gradient of every layer, less the
    input gradient of the first sparse conv, which no one needs."""
    first = sparse_convs(counts)[0]
    return 3 * forward_flops(counts) - conv_flops(first["cin"], first["cout"], first["hits"])
