/* Drop-in reference-ABI compatibility layer.
 *
 * Bit-exact re-declaration of the reference DLL's public struct layouts and
 * its exported entry point (`KernelWrapper`, Kernel.cu:873), so a host
 * application written against the reference's C ABI (e.g. the C# WPF app
 * P/Invoking the DLL) can load libmh_tpu.so without changing a single line
 * of its marshalling code. libmh_tpu_torch.so exports the same symbols
 * as mh_tpu's libmh_tpu.so, so a host links either one unchanged.
 *
 * Struct sources (all layouts verified 8/4-byte natural alignment,
 * identical under MSVC x64 and the System V x86-64 ABI — the complete
 * per-field offset table and the identity argument live in
 * ref_layout_asserts.h, which compiles under
 * --target=x86_64-pc-windows-msvc where a Windows-ABI clang is present):
 *   vertex                Kernel.cu:43-48    (24 bytes)
 *   rectangle             Kernel.cu:50-57    (20 bytes)
 *   positionAndRotation   Kernel.cu:59-72    (72 bytes; bool at offset 48)
 *   targetRangeStruct     Kernel.cu:74-77
 *   relationshipStruct    Kernel.cu:79-85    (32 bytes)
 *   relationshipAngleStruct Kernel.cu:87-92  (24 bytes)
 *   Surface               Kernel.cu:94-117   (80 bytes; doubles at 40)
 *   gpuConfig             Kernel.cu:119-127  (24 bytes)
 *   point                 Kernel.cu:129-132  (24 bytes)
 *   resultCosts           Kernel.cu:134-144  (32 bytes)
 *   result                Kernel.cu:146-149  (40 bytes)
 *
 * Semantics preserved from KernelWrapper (Kernel.cu:873-984):
 *  - gridxDim = number of chains/suggestions; blockxDim threads each inject
 *    a proposal per iteration AND draw an independent accept decision
 *    (Kernel.cu:798,819) -> mapped to n_moves_per_step = accept_draws =
 *    blockxDim. gridyDim/blockyDim/blockzDim are accepted and ignored,
 *    matching the reference's effective behavior: its launches use only
 *    the x dims (dim3(gridxDim), dim3(blockxDim), Kernel.cu:949-951).
 *  - the angle-relationship array is sized by nRelationships (the reference
 *    stages rsa with `sizeof(relationshipAngleStruct) * srf->nRelationships`,
 *    Kernel.cu:886, and PairWiseAngleCosts iterates nRelationships,
 *    Kernel.cu:241).
 *  - every rectangle's AABB is built from 4 *consecutive* vertices starting
 *    at point1Index (point2..4Index are never read, Kernel.cu:366-401).
 *  - the returned result array and the point array behind it are malloc'd
 *    and owned by the caller, exactly like the reference (which never frees
 *    them); KernelWrapperFree() is provided as an optional non-reference
 *    extension for hosts that want to release them.
 *  - unlike the reference, the returned resultCosts are REAL values (the
 *    reference's device writeback is commented out, Kernel.cu:852-861, so
 *    its costs are uninitialized memory).
 *
 * Seeding: the reference seeds cuRAND with time(NULL) (Kernel.cu:943). This
 * shim defaults to the same wall-clock seeding; set MH_TPU_SEED=<int> in
 * the environment for reproducible runs.
 */
#ifndef MH_TPU_REF_COMPAT_H_
#define MH_TPU_REF_COMPAT_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  double x;
  double y;
  double z;
} ref_vertex; /* vertex, Kernel.cu:43-48 */

typedef struct {
  int point1Index;
  int point2Index;
  int point3Index;
  int point4Index;
  int SourceIndex;
} ref_rectangle; /* rectangle, Kernel.cu:50-57 */

typedef struct {
  double x;
  double y;
  double z;
  double rotX;
  double rotY;
  double rotZ;
  unsigned char frozen; /* C++ bool: 1 byte + 7 padding before length */
  double length;
  double width;
} ref_positionAndRotation; /* positionAndRotation, Kernel.cu:59-72 */

typedef struct {
  double targetRangeStart;
  double targetRangeEnd;
} ref_targetRangeStruct; /* Kernel.cu:74-77 */

typedef struct {
  ref_targetRangeStruct TargetRange;
  int SourceIndex;
  int TargetIndex;
  double DegreesOfAtrraction; /* sic — never read (Kernel.cu:84) */
} ref_relationshipStruct; /* Kernel.cu:79-85 */

typedef struct {
  double angleMin;
  double angleMax;
  int SourceIndex;
  int TargetIndex;
} ref_relationshipAngleStruct; /* Kernel.cu:87-92 */

typedef struct {
  int nObjs;
  int nRelationships;
  int nClearances;
  float WeightFocalPoint;
  float WeightPairWise;
  float WeightVisualBalance;
  float WeightSymmetry;
  float WeightOffLimits;
  float WeightClearance;
  float WeightSurfaceArea;
  double centroidX;
  double centroidY;
  double focalX;
  double focalY;
  double focalRot;
} ref_Surface; /* Surface, Kernel.cu:94-117 */

typedef struct {
  int gridxDim;
  int gridyDim;
  int blockxDim;
  int blockyDim;
  int blockzDim;
  int iterations;
} ref_gpuConfig; /* gpuConfig, Kernel.cu:119-127 */

typedef struct {
  float x, y, z, rotX, rotY, rotZ;
} ref_point; /* point, Kernel.cu:129-132 */

typedef struct {
  float totalCosts;
  float PairWiseCosts;
  float VisualBalanceCosts;
  float FocalPointCosts;
  float SymmetryCosts;
  float ClearanceCosts;
  float OffLimitsCosts;
  float SurfaceAreaCosts;
} ref_resultCosts; /* resultCosts, Kernel.cu:134-144 */

typedef struct {
  ref_point* points;
  ref_resultCosts costs;
} ref_result; /* result, Kernel.cu:146-149 */

/* The reference's exact exported entry point (Kernel.cu:873), same
 * parameter order. Returns gridxDim results (NULL on error), each with
 * `points` pointing into one shared malloc'd array of gridxDim*nObjs
 * points — identical ownership/marshalling to the reference. */
ref_result* KernelWrapper(ref_relationshipStruct* rss,
                          ref_relationshipAngleStruct* rsa,
                          ref_positionAndRotation* cfg,
                          ref_rectangle* clearances,
                          ref_rectangle* offlimits,
                          ref_vertex* vertices,
                          ref_vertex* surfaceRectangle,
                          ref_Surface* srf,
                          ref_gpuConfig* gpuCfg);

/* Extension (absent in the reference, which leaks): releases the result
 * array and its shared point buffer. */
void KernelWrapperFree(ref_result* r);

#ifdef __cplusplus
}
#endif

#endif /* MH_TPU_REF_COMPAT_H_ */
