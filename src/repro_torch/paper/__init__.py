"""The paper's results computed by the port: Table I (mobile/cloud
offloading), Table II (cloud-API multiplexing), Fig. 1 (the zoo's
cross-model expertise) and Fig. 6 (embedding separation with and
without the contrastive loss).  ``python -m repro_torch.paper`` runs
all four; each runner's ``run(state)`` returns the JAX package's
runner's dict (``benchmarks/``) and prints its CSV rows."""
