// The device scratch of the merged MLP + out_proj backward, shared by K7
// (ln_mlp_out_residual_bwd.cu) and its regularized form K12a
// (ln_mlp_out_residual_bwd_train.cu): LN2 row statistics, the fp32 (rows,
// F) u/du buffer, g and du_c in the dtype, fp32 dh2 and dx1, and the
// partials of the column sums and the split-K weight gradients — carved
// from one workspace (Arena) the wrapper allocates.
#pragma once

#include "gemm.cuh"

namespace vt {

template <typename T>
struct K7Scratch {
  float *mean, *rstd, *u, *dh2, *dx1f, *cpart, *wpart;
  T *g, *du_c;
};

template <typename T>
K7Scratch<T> k7_scratch(Arena& a, int rows, int d, int f, int d_ctx) {
  K7Scratch<T> s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.u = a.take<float>((size_t)rows * f);
  s.g = a.take<T>((size_t)rows * f);
  s.du_c = a.take<T>((size_t)rows * f);
  s.dh2 = a.take<float>((size_t)rows * d);
  s.dx1f = a.take<float>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(f, d)));
  s.wpart = a.take<float>(std::max({wgrad_partial_floats<T>(d, f, rows),
                                    wgrad_partial_floats<T>(f, d, rows),
                                    wgrad_partial_floats<T>(d_ctx, d, rows)}));
  return s;
}

}  // namespace vt
