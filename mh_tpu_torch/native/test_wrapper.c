/* Standalone C host exercising the mh_tpu_torch native ABI end-to-end.
 *
 * The C-side equivalent of the reference's console harness main()
 * (Kernel.cu:1003-1218): builds the 32-object demo scene with the wire
 * structs, calls MHKernelWrapper, prints poses + (real) cost breakdowns.
 * Exits non-zero on any error or non-finite output. The engine runs on the
 * card unless MH_TPU_TORCH_DEVICE names another device.
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "wire.h"

static void set_quad(double* q, double w, double h, double x0, double y0) {
  q[0] = x0 + w; q[1] = y0 + h;
  q[2] = x0 + w; q[3] = y0;
  q[4] = x0;     q[5] = y0;
  q[6] = x0;     q[7] = y0 + h;
}

int main(void) {
  const int64_t N = 32, CHAINS = 2, ITERS = 50;

  char report[512];
  if (MHDeviceReport(report, sizeof(report)) != 0) {
    fprintf(stderr, "device report failed\n");
    return 1;
  }
  printf("%s\n", report);

  mh_surface srf;
  memset(&srf, 0, sizeof(srf));
  srf.n_objs = N;
  srf.n_relationships = 1;
  srf.n_angle_relationships = 1;
  srf.n_clearances = 2;
  srf.w_focal_point = -2.0;
  srf.w_pair_wise = -2.0;
  srf.w_visual_balance = 1.5;
  srf.w_symmetry = -2.0;
  srf.w_off_limits = 0.0;
  srf.w_clearance = -2.0;
  srf.w_surface_area = -2.0;
  srf.focal_x = 5.0;
  srf.focal_y = 5.0;
  set_quad(srf.surface_quad, 10, 10, 0, 0);

  mh_pose poses[32];
  mh_rect offlimits[32];
  memset(poses, 0, sizeof(poses));
  memset(offlimits, 0, sizeof(offlimits));
  for (int64_t i = 0; i < N; i++) {
    poses[i].x = 2.0 * (double)i;
    poses[i].y = 2.0 * (double)i;
    poses[i].length = 1.0;
    poses[i].width = 1.0;
    set_quad(offlimits[i].quad, 2, 2, (i % 2) ? 1.0 : 0.0, 0.0);
    offlimits[i].source_index = i % 2;
  }

  mh_relationship rel = {2.0, 4.0, 2.0, 0, 1};
  mh_angle_relationship ang = {3.1416 / 4, 5 * 3.1416 / 8, 0, 1};
  mh_rect clearances[2];
  memset(clearances, 0, sizeof(clearances));
  set_quad(clearances[0].quad, 2, 2, 0, 0);
  clearances[0].source_index = 0;
  set_quad(clearances[1].quad, 2, 2, 1, 0);
  clearances[1].source_index = 1;

  mh_config cfg = {CHAINS, ITERS, 1, 1, 1, 0, 0.0};

  double* out_points = malloc(sizeof(double) * CHAINS * N * 6);
  mh_result_costs* out_costs = malloc(sizeof(mh_result_costs) * CHAINS);
  double* out_accept = malloc(sizeof(double) * CHAINS);

  int64_t rc = MHKernelWrapper(&srf, &rel, &ang, poses, clearances, offlimits,
                               &cfg, out_points, out_costs, out_accept);
  if (rc != 0) {
    fprintf(stderr, "MHKernelWrapper failed: %lld\n", (long long)rc);
    return 2;
  }

  for (int64_t c = 0; c < CHAINS; c++) {
    printf("Result %lld (accept %.2f)\n", (long long)c, out_accept[c]);
    printf("  costs: total=%.3f pair=%.3f visual=%.3f focal=%.3f sym=%.3f "
           "clear=%.3f off=%.3f surf=%.3f\n",
           out_costs[c].total, out_costs[c].pair_wise,
           out_costs[c].visual_balance, out_costs[c].focal_point,
           out_costs[c].symmetry, out_costs[c].clearance,
           out_costs[c].off_limits, out_costs[c].surface_area);
    if (!isfinite(out_costs[c].total) || out_accept[c] <= 0.0) {
      fprintf(stderr, "bad outputs\n");
      return 3;
    }
    for (int64_t j = 0; j < 4; j++) {
      const double* p = out_points + (c * N + j) * 6;
      printf("  Point [%lld] X,Y,Z: %f, %f, %f  Rot: %f, %f, %f\n",
             (long long)j, p[0], p[1], p[2], p[3], p[4], p[5]);
      if (!isfinite(p[0]) || !isfinite(p[1])) {
        fprintf(stderr, "non-finite pose\n");
        return 4;
      }
    }
  }
  printf("native ABI smoke test OK\n");
  free(out_points);
  free(out_costs);
  free(out_accept);
  return 0;
}
