from reference.dataplane import Deployment

__all__ = ["Deployment"]
