"""icp_tpu — point-cloud registration and SLAM engine in JAX (GPU-first).

Brand-new JAX/XLA/Pallas implementation with the capabilities of the reference
C++/CUDA ICP project (`yassram/iterative-closest-point`); see SURVEY.md for
the component-by-component mapping and docs/ for the architecture.
"""

from icp_tpu.config import ICPConfig
from icp_tpu.engine.batched import (
    batch_pairs,
    icp_batched,
    register_chain_batched,
)
from icp_tpu.engine.gicp import icp_generalized, icp_generalized_sharded
from icp_tpu.engine.icp import (
    ICPResult,
    ICPTrace,
    icp,
    icp_fixed_iters,
    icp_resumable,
    icp_step,
)
from icp_tpu.engine.point_to_plane import (
    icp_point_to_plane,
    icp_point_to_plane_sharded,
)
from icp_tpu.engine.symmetric import icp_symmetric, icp_symmetric_sharded
from icp_tpu.engine.global_reg import (
    GlobalRegResult,
    compatibility_scores,
    global_register,
    match_features,
    ransac_alignment,
)
from icp_tpu.ops.fpfh import fpfh_features
from icp_tpu.slam.closure import (
    ClosureCandidate,
    chain_edges_from_pairs,
    detect_loop_closures,
    overlap_fraction,
    refine_closures,
    verified_inlier_fraction,
)
from icp_tpu.ops.normals import estimate_normals, orient_normals
from icp_tpu.ops.padding import auto_quantum, pad_to_bucket
from icp_tpu.ops.voxel import voxel_downsample, voxel_downsample_np
from icp_tpu.io.csv import load_matrix, write_matrix
from icp_tpu.parallel.mesh import init_distributed, make_mesh
from icp_tpu.parallel.sharded import icp_sharded, icp_sharded_2d, make_mesh_2d
from icp_tpu.slam.pairwise import (
    chain_to_world_poses,
    initialize_pca,
    register_chain,
    register_pair,
)
from icp_tpu.slam.pose_graph import (
    PoseEdge,
    bundle_adjust,
    bundle_adjust_sharded,
    optimize_pose_graph,
)
from icp_tpu.ops.alignment import (
    AlignmentStats,
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
    find_alignment,
)
from icp_tpu.ops.distance import closest_point_indices
from icp_tpu.ops.transform import (
    apply_similarity,
    compose,
    identity_similarity,
    inverse,
)

__version__ = "0.1.0"

__all__ = [
    "ICPConfig",
    "ICPResult",
    "ICPTrace",
    "icp",
    "icp_batched",
    "batch_pairs",
    "register_chain_batched",
    "auto_quantum",
    "pad_to_bucket",
    "icp_generalized",
    "icp_generalized_sharded",
    "icp_point_to_plane",
    "icp_symmetric",
    "icp_symmetric_sharded",
    "icp_point_to_plane_sharded",
    "estimate_normals",
    "orient_normals",
    "GlobalRegResult",
    "compatibility_scores",
    "global_register",
    "match_features",
    "ransac_alignment",
    "fpfh_features",
    "ClosureCandidate",
    "chain_edges_from_pairs",
    "detect_loop_closures",
    "overlap_fraction",
    "refine_closures",
    "verified_inlier_fraction",
    "voxel_downsample",
    "voxel_downsample_np",
    "icp_fixed_iters",
    "icp_resumable",
    "icp_sharded",
    "icp_sharded_2d",
    "icp_step",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "register_pair",
    "register_chain",
    "chain_to_world_poses",
    "initialize_pca",
    "PoseEdge",
    "optimize_pose_graph",
    "bundle_adjust",
    "bundle_adjust_sharded",
    "load_matrix",
    "write_matrix",
    "AlignmentStats",
    "Similarity",
    "alignment_from_stats",
    "compute_alignment_stats",
    "find_alignment",
    "closest_point_indices",
    "apply_similarity",
    "compose",
    "identity_similarity",
    "inverse",
]
