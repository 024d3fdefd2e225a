"""Model workloads that run over the OCM data plane."""
