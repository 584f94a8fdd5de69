"""Encode layer: mean ms per answer in InterPodAffinity's encode of the pod's and the residents' terms, from the program's span ipa.encode (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_answer_ms(info, ["ipa.encode"])
