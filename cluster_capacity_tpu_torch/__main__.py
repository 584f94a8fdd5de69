"""`python -m cluster_capacity_tpu_torch` → hypercc multiplexer."""
from .cli.hypercc import main

main()
