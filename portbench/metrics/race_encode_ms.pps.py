"""Encode layer: mean ms per answer in the queue engine's encode, the templates' shared encode and each group's tensors, from the program's span interleave.encode (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_answer_ms(info, ["interleave.encode"])
