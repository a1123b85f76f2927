from .metrics import ec_integrity_metrics

__all__ = ["ec_integrity_metrics"]
