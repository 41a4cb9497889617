from ccfd_tpu_torch.observability.dashboards import build_all_dashboards, write_dashboards  # noqa: F401
