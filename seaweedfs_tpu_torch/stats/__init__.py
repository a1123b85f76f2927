from .aggregate import (ClusterAggregator, merge_families,
                        parse_prometheus_text)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, Registry,
                      coordinator_metrics, dataplane_metrics,
                      degraded_bind_metrics, ec_integrity_metrics,
                      heat_metrics, ledger_metrics,
                      master_metrics, needle_cache_metrics,
                      request_plane_metrics, volume_server_metrics)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "volume_server_metrics", "ec_integrity_metrics", "coordinator_metrics",
    "master_metrics", "request_plane_metrics", "dataplane_metrics",
    "needle_cache_metrics", "degraded_bind_metrics", "heat_metrics",
    "ledger_metrics",
    "ClusterAggregator", "merge_families", "parse_prometheus_text",
]
