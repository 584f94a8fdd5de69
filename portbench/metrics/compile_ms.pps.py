"""Host runtime: mean ms per answer of compiles (kernel builds, CUDA-graph captures), charged to the program's spans (compile_s) (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.charged_ms(info, "compile_s")
