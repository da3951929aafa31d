/* Reference-ABI drop-in test: fills the scene EXACTLY as the reference's
 * console harness main() does (Kernel.cu:1003-1194) — same struct layouts,
 * same vertex pool/indices, same launch config (1 block x 64 threads x 100
 * iterations) — and calls the exported KernelWrapper. A host built against
 * the reference DLL could swap in libmh_tpu_torch.so unchanged.
 *
 * Also static-asserts every struct layout against the reference's x64 ABI
 * sizes/offsets, and checks determinism under MH_TPU_SEED.
 */
#include <assert.h>
#include <math.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>

#include "ref_compat.h"
/* layout pins: EVERY field offset/struct size vs the x64 ABI the
 * reference DLL exposes to P/Invoke — see ref_layout_asserts.h for the
 * complete table and the MSVC-x64 / SysV identity argument (checkable
 * under a Windows-ABI compiler). */
#include "ref_layout_asserts.h"

#define PI (3.1416) /* Kernel.cu:31 */

static ref_result* run_reference_demo(void) {
  /* --- verbatim re-creation of main(), Kernel.cu:1007-1194 ------------- */
  enum { N = 32, NRel = 1, NClearances = 2 };
  static ref_Surface srf;
  srf.nObjs = N;
  srf.nRelationships = NRel;
  srf.nClearances = NClearances;
  srf.WeightFocalPoint = -2.0f;
  srf.WeightPairWise = -2.0f;
  srf.WeightVisualBalance = 1.5f;
  srf.WeightSymmetry = -2.0f;
  /* WeightOffLimits left uninitialized in the reference (Kernel.cu:1014-
   * 1019); it is excluded from the total either way — zero here */
  srf.WeightOffLimits = 0.0f;
  srf.WeightClearance = -2.0f;
  srf.WeightSurfaceArea = -2.0f;
  srf.centroidX = 0.0;
  srf.centroidY = 0.0;
  srf.focalX = 5.0;
  srf.focalY = 5.0;
  srf.focalRot = 0.0;

  static ref_vertex surfaceRectangle[4] = {
      {10, 10, 0}, {10, 0, 0}, {0, 0, 0}, {0, 10, 0}};

  static ref_vertex vtx[16] = {
      /* clearance shapes (Kernel.cu:1047-1078) */
      {2, 2, 0}, {2, 0, 0}, {0, 0, 0}, {0, 2, 0},
      {3, 2, 0}, {3, 0, 0}, {1, 0, 0}, {1, 2, 0},
      /* off-limits shapes (Kernel.cu:1080-1111) */
      {2, 2, 0}, {2, 0, 0}, {0, 0, 0}, {0, 2, 0},
      {3, 2, 0}, {3, 0, 0}, {1, 0, 0}, {1, 2, 0}};

  static ref_rectangle clearances[NClearances] = {
      {0, 1, 2, 3, 0}, {4, 5, 6, 7, 1}};

  static ref_rectangle offlimits[N];
  for (int i = 0; i < N; i++) {
    if (i % 2 == 0) {
      offlimits[i] = (ref_rectangle){8, 9, 10, 11, 0};
    } else {
      offlimits[i] = (ref_rectangle){12, 13, 14, 15, 1};
    }
  }

  static ref_positionAndRotation cfg[N];
  for (int i = 0; i < N; i++) {
    cfg[i].x = i * 2.0;
    cfg[i].y = i * 2.0;
    cfg[i].z = 0.0;
    cfg[i].rotX = 0.0;
    cfg[i].rotY = 0.0;
    cfg[i].rotZ = 0.0;
    cfg[i].frozen = 0;
    cfg[i].length = 1.0;
    cfg[i].width = 1.0;
  }

  static ref_relationshipStruct rss[NRel];
  rss[0].TargetRange.targetRangeStart = 2.0;
  rss[0].TargetRange.targetRangeEnd = 4.0;
  rss[0].DegreesOfAtrraction = 2.0;
  rss[0].SourceIndex = 0;
  rss[0].TargetIndex = 1;

  static ref_relationshipAngleStruct rsa[NRel];
  rsa[0].angleMin = PI / 4;
  rsa[0].angleMax = 5 * PI / 8;
  rsa[0].SourceIndex = 0;
  rsa[0].TargetIndex = 1;

  ref_gpuConfig gpuCfg;
  gpuCfg.gridxDim = 1;
  gpuCfg.gridyDim = 0;
  gpuCfg.blockxDim = 64;
  gpuCfg.blockyDim = 0;
  gpuCfg.blockzDim = 0;
  gpuCfg.iterations = 100;

  return KernelWrapper(rss, rsa, cfg, clearances, offlimits, vtx,
                       surfaceRectangle, &srf, &gpuCfg);
}

int main(void) {
  setenv("MH_TPU_SEED", "1234", 1);
  ref_result* result = run_reference_demo();
  if (!result) {
    fprintf(stderr, "KernelWrapper returned NULL\n");
    return 2;
  }

  /* the reference main() print loop (Kernel.cu:1199-1214), with checks */
  printf("Results:\n");
  for (int i = 0; i < 1; i++) {
    printf("Result %d\n", i);
    printf("costs: total=%f pair=%f visual=%f focal=%f sym=%f clear=%f "
           "off=%f surf=%f\n",
           result[i].costs.totalCosts, result[i].costs.PairWiseCosts,
           result[i].costs.VisualBalanceCosts, result[i].costs.FocalPointCosts,
           result[i].costs.SymmetryCosts, result[i].costs.ClearanceCosts,
           result[i].costs.OffLimitsCosts, result[i].costs.SurfaceAreaCosts);
    if (!isfinite(result[i].costs.totalCosts)) {
      fprintf(stderr, "uninitialized/garbage costs (the reference bug we "
                      "fix, Kernel.cu:852-861)\n");
      return 3;
    }
    for (int j = 0; j < 32; j++) {
      ref_point* p = &result[i].points[j];
      if (j < 4)
        printf("Point [%d] X,Y,Z: %f, %f, %f\tRotation: %f, %f, %f\n", j,
               p->x, p->y, p->z, p->rotX, p->rotY, p->rotZ);
      if (!isfinite(p->x) || !isfinite(p->y) || !isfinite(p->rotY)) {
        fprintf(stderr, "non-finite pose\n");
        return 4;
      }
    }
  }

  /* determinism under MH_TPU_SEED: a second identical call must agree */
  ref_result* again = run_reference_demo();
  if (!again) return 5;
  for (int j = 0; j < 32; j++) {
    if (result[0].points[j].x != again[0].points[j].x ||
        result[0].points[j].rotY != again[0].points[j].rotY) {
      fprintf(stderr, "non-deterministic under fixed MH_TPU_SEED\n");
      return 6;
    }
  }
  if (result[0].costs.totalCosts != again[0].costs.totalCosts) return 7;

  KernelWrapperFree(result);
  KernelWrapperFree(again);
  printf("reference-ABI drop-in test OK\n");
  return 0;
}
