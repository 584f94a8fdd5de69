from .cli.cluster_capacity import main

main()
