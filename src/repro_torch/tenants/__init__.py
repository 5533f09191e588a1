"""Multi-tenant curvature (torch port of ``repro.tenants``): one shared
base factor, per-tenant rank-r dual-space deltas (``delta`` — the
algebra). ``TenantManager`` (residency under a byte budget, spill to
disk) and the servers' ``tenants=`` hook come with the next slice."""
from repro_torch.tenants.delta import (TenantDelta, augmented_window,
                                       delta_correction, delta_factor,
                                       delta_fold, delta_nbytes,
                                       init_tenant_delta, project_rows,
                                       tenant_factorization)

__all__ = [
    "TenantDelta",
    "init_tenant_delta",
    "project_rows",
    "delta_fold",
    "delta_correction",
    "delta_factor",
    "tenant_factorization",
    "augmented_window",
    "delta_nbytes",
]
