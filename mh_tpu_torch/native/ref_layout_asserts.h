/* Complete compile-time proof of the reference wire layouts (x64).
 *
 * EVERY field offset and struct size of ref_compat.h is pinned to a hard
 * numeric constant here — nothing is "whatever this compiler computed".
 * The file compiles as C11 (_Static_assert) and C++11 (static_assert),
 * under both target ABIs:
 *
 *   - System V x86-64 (g++/clang on Linux — checked by every build of
 *                      test_ref_compat.c, which includes this file)
 *   - MSVC x64        (the reference DLL's ABI, Kernel.vcxproj:29 —
 *                      checkable with a clang given
 *                      --target=x86_64-pc-windows-msvc)
 *
 * Why the two ABIs agree on these numbers (the documented argument, for
 * environments without a Windows-ABI compiler): every struct member is
 * one of {int, float, double, unsigned char, pointer} — no `long` (4
 * bytes under MSVC x64, 8 under SysV: the one primitive the two ABIs size
 * differently), no `long double` (8 vs 16), no bitfields (layout rules
 * differ), no enums, no over-aligned or empty types, no inheritance.
 * For plain structs of these primitives both ABIs use the identical
 * natural-alignment algorithm: each member at the next multiple of its
 * alignment (int/float: 4, double/pointer: 8, char: 1), struct alignment
 * = max member alignment, size rounded up to it. The PRIMITIVE_MODEL
 * asserts below pin those sizes/alignments; given them, the offsets are
 * arithmetic, which the per-field asserts spell out exhaustively.
 */
#ifndef MH_TPU_REF_LAYOUT_ASSERTS_H_
#define MH_TPU_REF_LAYOUT_ASSERTS_H_

#include <stddef.h>

#include "ref_compat.h"

#ifdef __cplusplus
#define MH_ASSERT(cond, msg) static_assert(cond, msg)
#define MH_ALIGNOF(t) alignof(t)
#else
#define MH_ASSERT(cond, msg) _Static_assert(cond, msg)
#define MH_ALIGNOF(t) _Alignof(t)
#endif

/* --- PRIMITIVE_MODEL: the common x64 primitive layout ------------------- */
MH_ASSERT(sizeof(int) == 4, "int");
MH_ASSERT(sizeof(float) == 4, "float");
MH_ASSERT(sizeof(double) == 8, "double");
MH_ASSERT(sizeof(unsigned char) == 1, "uchar");
MH_ASSERT(sizeof(void*) == 8, "ptr");
MH_ASSERT(MH_ALIGNOF(double) == 8, "align(double)");
MH_ASSERT(MH_ALIGNOF(void*) == 8, "align(ptr)");
MH_ASSERT(MH_ALIGNOF(int) == 4, "align(int)");
MH_ASSERT(MH_ALIGNOF(float) == 4, "align(float)");

/* --- vertex (Kernel.cu:43-48): 3 doubles --------------------------------- */
MH_ASSERT(sizeof(ref_vertex) == 24, "vertex size");
MH_ASSERT(offsetof(ref_vertex, x) == 0, "vertex.x");
MH_ASSERT(offsetof(ref_vertex, y) == 8, "vertex.y");
MH_ASSERT(offsetof(ref_vertex, z) == 16, "vertex.z");

/* --- rectangle (Kernel.cu:50-57): 5 ints --------------------------------- */
MH_ASSERT(sizeof(ref_rectangle) == 20, "rectangle size");
MH_ASSERT(offsetof(ref_rectangle, point1Index) == 0, "rect.p1");
MH_ASSERT(offsetof(ref_rectangle, point2Index) == 4, "rect.p2");
MH_ASSERT(offsetof(ref_rectangle, point3Index) == 8, "rect.p3");
MH_ASSERT(offsetof(ref_rectangle, point4Index) == 12, "rect.p4");
MH_ASSERT(offsetof(ref_rectangle, SourceIndex) == 16, "rect.src");

/* --- positionAndRotation (Kernel.cu:59-72) -------------------------------
 * 6 doubles, then a 1-byte bool padded to the next 8-byte boundary for the
 * trailing doubles — identical padding under both ABIs. */
MH_ASSERT(sizeof(ref_positionAndRotation) == 72, "pose size");
MH_ASSERT(offsetof(ref_positionAndRotation, x) == 0, "pose.x");
MH_ASSERT(offsetof(ref_positionAndRotation, y) == 8, "pose.y");
MH_ASSERT(offsetof(ref_positionAndRotation, z) == 16, "pose.z");
MH_ASSERT(offsetof(ref_positionAndRotation, rotX) == 24, "pose.rotX");
MH_ASSERT(offsetof(ref_positionAndRotation, rotY) == 32, "pose.rotY");
MH_ASSERT(offsetof(ref_positionAndRotation, rotZ) == 40, "pose.rotZ");
MH_ASSERT(offsetof(ref_positionAndRotation, frozen) == 48, "pose.frozen");
MH_ASSERT(offsetof(ref_positionAndRotation, length) == 56, "pose.length");
MH_ASSERT(offsetof(ref_positionAndRotation, width) == 64, "pose.width");

/* --- targetRangeStruct (Kernel.cu:74-77) --------------------------------- */
MH_ASSERT(sizeof(ref_targetRangeStruct) == 16, "range size");
MH_ASSERT(offsetof(ref_targetRangeStruct, targetRangeStart) == 0, "range.lo");
MH_ASSERT(offsetof(ref_targetRangeStruct, targetRangeEnd) == 8, "range.hi");

/* --- relationshipStruct (Kernel.cu:79-85) --------------------------------
 * nested 16-byte range + 2 ints + a double (ints pack into one 8-byte
 * slot; the double lands naturally at 24 — no tail padding). */
MH_ASSERT(sizeof(ref_relationshipStruct) == 32, "rel size");
MH_ASSERT(offsetof(ref_relationshipStruct, TargetRange) == 0, "rel.range");
MH_ASSERT(offsetof(ref_relationshipStruct, SourceIndex) == 16, "rel.src");
MH_ASSERT(offsetof(ref_relationshipStruct, TargetIndex) == 20, "rel.tgt");
MH_ASSERT(offsetof(ref_relationshipStruct, DegreesOfAtrraction) == 24,
          "rel.degrees");

/* --- relationshipAngleStruct (Kernel.cu:87-92) --------------------------- */
MH_ASSERT(sizeof(ref_relationshipAngleStruct) == 24, "relA size");
MH_ASSERT(offsetof(ref_relationshipAngleStruct, angleMin) == 0, "relA.min");
MH_ASSERT(offsetof(ref_relationshipAngleStruct, angleMax) == 8, "relA.max");
MH_ASSERT(offsetof(ref_relationshipAngleStruct, SourceIndex) == 16, "relA.src");
MH_ASSERT(offsetof(ref_relationshipAngleStruct, TargetIndex) == 20, "relA.tgt");

/* --- Surface (Kernel.cu:94-117) ------------------------------------------
 * 3 ints + 7 floats = 40 bytes (both 4-aligned, no padding), then 5
 * doubles at 40 — 40 is already 8-aligned, so no gap under either ABI. */
MH_ASSERT(sizeof(ref_Surface) == 80, "surface size");
MH_ASSERT(offsetof(ref_Surface, nObjs) == 0, "srf.nObjs");
MH_ASSERT(offsetof(ref_Surface, nRelationships) == 4, "srf.nRel");
MH_ASSERT(offsetof(ref_Surface, nClearances) == 8, "srf.nClr");
MH_ASSERT(offsetof(ref_Surface, WeightFocalPoint) == 12, "srf.wFP");
MH_ASSERT(offsetof(ref_Surface, WeightPairWise) == 16, "srf.wPW");
MH_ASSERT(offsetof(ref_Surface, WeightVisualBalance) == 20, "srf.wVB");
MH_ASSERT(offsetof(ref_Surface, WeightSymmetry) == 24, "srf.wSY");
MH_ASSERT(offsetof(ref_Surface, WeightOffLimits) == 28, "srf.wOL");
MH_ASSERT(offsetof(ref_Surface, WeightClearance) == 32, "srf.wCL");
MH_ASSERT(offsetof(ref_Surface, WeightSurfaceArea) == 36, "srf.wSA");
MH_ASSERT(offsetof(ref_Surface, centroidX) == 40, "srf.cx");
MH_ASSERT(offsetof(ref_Surface, centroidY) == 48, "srf.cy");
MH_ASSERT(offsetof(ref_Surface, focalX) == 56, "srf.fx");
MH_ASSERT(offsetof(ref_Surface, focalY) == 64, "srf.fy");
MH_ASSERT(offsetof(ref_Surface, focalRot) == 72, "srf.frot");

/* --- gpuConfig (Kernel.cu:119-127): 6 ints ------------------------------- */
MH_ASSERT(sizeof(ref_gpuConfig) == 24, "gpuConfig size");
MH_ASSERT(offsetof(ref_gpuConfig, gridxDim) == 0, "cfg.gx");
MH_ASSERT(offsetof(ref_gpuConfig, gridyDim) == 4, "cfg.gy");
MH_ASSERT(offsetof(ref_gpuConfig, blockxDim) == 8, "cfg.bx");
MH_ASSERT(offsetof(ref_gpuConfig, blockyDim) == 12, "cfg.by");
MH_ASSERT(offsetof(ref_gpuConfig, blockzDim) == 16, "cfg.bz");
MH_ASSERT(offsetof(ref_gpuConfig, iterations) == 20, "cfg.iters");

/* --- point (Kernel.cu:129-132): 6 floats --------------------------------- */
MH_ASSERT(sizeof(ref_point) == 24, "point size");
MH_ASSERT(offsetof(ref_point, x) == 0 && offsetof(ref_point, rotZ) == 20,
          "point fields");

/* --- resultCosts (Kernel.cu:134-144): 8 floats --------------------------- */
MH_ASSERT(sizeof(ref_resultCosts) == 32, "resultCosts size");
MH_ASSERT(offsetof(ref_resultCosts, totalCosts) == 0, "rc.total");
MH_ASSERT(offsetof(ref_resultCosts, SurfaceAreaCosts) == 28, "rc.sa");

/* --- result (Kernel.cu:146-149): pointer + nested costs ------------------ */
MH_ASSERT(sizeof(ref_result) == 40, "result size");
MH_ASSERT(offsetof(ref_result, points) == 0, "res.points");
MH_ASSERT(offsetof(ref_result, costs) == 8, "res.costs");

#undef MH_ASSERT
#undef MH_ALIGNOF

#endif /* MH_TPU_REF_LAYOUT_ASSERTS_H_ */
