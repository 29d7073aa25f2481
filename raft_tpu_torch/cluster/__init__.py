"""Cluster layer: Lloyd k-means (``kmeans``), balanced k-means, the IVF
coarse-quantizer trainer (``kmeans_balanced``), and single linkage
(``single_linkage``)."""

from raft_tpu_torch.cluster import kmeans, kmeans_balanced, single_linkage
from raft_tpu_torch.cluster.kmeans import KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.cluster.single_linkage import SingleLinkageParams

__all__ = ["kmeans", "kmeans_balanced", "single_linkage", "KMeansParams",
           "KMeansBalancedParams", "SingleLinkageParams"]
