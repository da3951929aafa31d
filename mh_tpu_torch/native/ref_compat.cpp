/* Drop-in reference-ABI shim: exported KernelWrapper (see ref_compat.h).
 *
 * Marshals the reference's struct layouts (Kernel.cu:43-149) into the
 * wire format (wire.h) and forwards to MHKernelWrapper, exactly as mh_tpu's
 * ref_compat.cpp does — so the reference's DLL consumers get the port's
 * engine (the fused CUDA kernel on the card) behind the exact ABI they
 * already speak, with real cost breakdowns instead of the reference's
 * uninitialized ones (Kernel.cu:852-861).
 */

#include "ref_compat.h"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#include "wire.h"

namespace {

/* rectangle -> inline quad: 4 consecutive vertices starting at point1Index
 * (point2..4Index are set by reference callers but never read,
 * Kernel.cu:366-401 / :1113). */
mh_rect to_mh_rect(const ref_rectangle& r, const ref_vertex* pool) {
  mh_rect out;
  for (int k = 0; k < 4; ++k) {
    out.quad[2 * k] = pool[r.point1Index + k].x;
    out.quad[2 * k + 1] = pool[r.point1Index + k].y;
  }
  out.source_index = r.SourceIndex;
  return out;
}

}  // namespace

extern "C" ref_result* KernelWrapper(ref_relationshipStruct* rss,
                                     ref_relationshipAngleStruct* rsa,
                                     ref_positionAndRotation* cfg,
                                     ref_rectangle* clearances,
                                     ref_rectangle* offlimits,
                                     ref_vertex* vertices,
                                     ref_vertex* surfaceRectangle,
                                     ref_Surface* srf,
                                     ref_gpuConfig* gpuCfg) {
  if (!cfg || !srf || !gpuCfg || !surfaceRectangle) return nullptr;
  const int n = srf->nObjs;
  const int n_rel = srf->nRelationships;
  const int n_clr = srf->nClearances;
  const int chains = gpuCfg->gridxDim;
  if (n <= 0 || chains <= 0) return nullptr;

  mh_surface s;
  std::memset(&s, 0, sizeof(s));
  s.n_objs = n;
  s.n_relationships = n_rel;
  /* reference quirk: the angle array is sized AND iterated by
   * nRelationships (Kernel.cu:886, :241) */
  s.n_angle_relationships = n_rel;
  s.n_clearances = n_clr;
  s.w_focal_point = srf->WeightFocalPoint;
  s.w_pair_wise = srf->WeightPairWise;
  s.w_visual_balance = srf->WeightVisualBalance;
  s.w_symmetry = srf->WeightSymmetry;
  s.w_off_limits = srf->WeightOffLimits;
  s.w_clearance = srf->WeightClearance;
  s.w_surface_area = srf->WeightSurfaceArea;
  s.centroid_x = srf->centroidX;
  s.centroid_y = srf->centroidY;
  s.focal_x = srf->focalX;
  s.focal_y = srf->focalY;
  s.focal_rot = srf->focalRot;
  for (int k = 0; k < 4; ++k) {
    s.surface_quad[2 * k] = surfaceRectangle[k].x;
    s.surface_quad[2 * k + 1] = surfaceRectangle[k].y;
  }

  std::vector<mh_pose> poses(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    poses[i].x = cfg[i].x;
    poses[i].y = cfg[i].y;
    poses[i].z = cfg[i].z;
    poses[i].rot_x = cfg[i].rotX;
    poses[i].rot_y = cfg[i].rotY;
    poses[i].rot_z = cfg[i].rotZ;
    poses[i].length = cfg[i].length;
    poses[i].width = cfg[i].width;
    poses[i].frozen = cfg[i].frozen ? 1 : 0;
  }

  std::vector<mh_relationship> rels(static_cast<size_t>(n_rel));
  std::vector<mh_angle_relationship> angs(static_cast<size_t>(n_rel));
  for (int i = 0; i < n_rel; ++i) {
    rels[i].range_start = rss[i].TargetRange.targetRangeStart;
    rels[i].range_end = rss[i].TargetRange.targetRangeEnd;
    rels[i].degrees_of_attraction = rss[i].DegreesOfAtrraction;
    rels[i].source_index = rss[i].SourceIndex;
    rels[i].target_index = rss[i].TargetIndex;
    angs[i].angle_min = rsa[i].angleMin;
    angs[i].angle_max = rsa[i].angleMax;
    angs[i].source_index = rsa[i].SourceIndex;
    angs[i].target_index = rsa[i].TargetIndex;
  }

  std::vector<mh_rect> clr(static_cast<size_t>(n_clr));
  for (int i = 0; i < n_clr; ++i) clr[i] = to_mh_rect(clearances[i], vertices);
  std::vector<mh_rect> off(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) off[i] = to_mh_rect(offlimits[i], vertices);

  mh_config mc;
  std::memset(&mc, 0, sizeof(mc));
  mc.n_chains = chains;
  mc.iterations = gpuCfg->iterations;
  /* blockxDim threads each inject one move per iteration (Kernel.cu:798)
   * and each draws an independent accept decision (Kernel.cu:819) */
  const int block = gpuCfg->blockxDim > 0 ? gpuCfg->blockxDim : 1;
  mc.moves_per_step = block;
  mc.accept_draws = block;
  mc.parity_mode = 1; /* the reference semantics, quirks included */
  const char* seed_env = std::getenv("MH_TPU_SEED");
  mc.seed = seed_env ? std::atoll(seed_env)
                     : static_cast<int64_t>(std::time(nullptr));
  mc.beta = 0.0; /* reference BETA = 2.0 */

  std::vector<double> out_points(static_cast<size_t>(chains) * n * 6);
  std::vector<mh_result_costs> out_costs(static_cast<size_t>(chains));
  std::vector<double> out_accept(static_cast<size_t>(chains));

  const int64_t rc = MHKernelWrapper(&s, rels.data(), angs.data(),
                                     poses.data(), clr.data(), off.data(),
                                     &mc, out_points.data(), out_costs.data(),
                                     out_accept.data());
  if (rc != 0) {
    std::fprintf(stderr, "KernelWrapper: engine failed (%lld)\n",
                 static_cast<long long>(rc));
    return nullptr;
  }

  /* marshal exactly like the reference (Kernel.cu:970-983): one shared
   * malloc'd point array, per-chain result entries pointing into it */
  ref_point* pts = static_cast<ref_point*>(
      std::malloc(sizeof(ref_point) * static_cast<size_t>(chains) * n));
  ref_result* res = static_cast<ref_result*>(
      std::malloc(sizeof(ref_result) * static_cast<size_t>(chains)));
  if (!pts || !res) {
    std::free(pts);
    std::free(res);
    return nullptr;
  }
  for (int c = 0; c < chains; ++c) {
    for (int j = 0; j < n; ++j) {
      const double* p = &out_points[(static_cast<size_t>(c) * n + j) * 6];
      ref_point& q = pts[static_cast<size_t>(c) * n + j];
      q.x = static_cast<float>(p[0]);
      q.y = static_cast<float>(p[1]);
      q.z = static_cast<float>(p[2]);
      q.rotX = static_cast<float>(p[3]);
      q.rotY = static_cast<float>(p[4]);
      q.rotZ = static_cast<float>(p[5]);
    }
    const mh_result_costs& k = out_costs[static_cast<size_t>(c)];
    res[c].points = &pts[static_cast<size_t>(c) * n];
    res[c].costs.totalCosts = static_cast<float>(k.total);
    res[c].costs.PairWiseCosts = static_cast<float>(k.pair_wise);
    res[c].costs.VisualBalanceCosts = static_cast<float>(k.visual_balance);
    res[c].costs.FocalPointCosts = static_cast<float>(k.focal_point);
    res[c].costs.SymmetryCosts = static_cast<float>(k.symmetry);
    res[c].costs.ClearanceCosts = static_cast<float>(k.clearance);
    res[c].costs.OffLimitsCosts = static_cast<float>(k.off_limits);
    res[c].costs.SurfaceAreaCosts = static_cast<float>(k.surface_area);
  }
  return res;
}

extern "C" void KernelWrapperFree(ref_result* r) {
  if (!r) return;
  std::free(r[0].points); /* chain 0 points at the shared array base */
  std::free(r);
}
