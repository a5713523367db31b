from .client import KubeClient, KubeCluster, run_scheduler_against_cluster
from .leaderelect import LeaderElector

__all__ = ["KubeClient", "KubeCluster", "run_scheduler_against_cluster", "LeaderElector"]
