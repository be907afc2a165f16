// The convolution that the chain kernels share (K3 and K4 in tail_chain.cu,
// K6 through ops/kernels/conv_tile.py): its arguments and its launchers.
// The kernels themselves are in conv_tile.cu, compiled once; this header
// is what the other sources of the library see of them.
#pragma once

#include <cuda_runtime.h>

namespace adam {

struct ConvArgs {
  const void* in[2];     // sources, NHWC (N, H, W, c[s]); in[1] may be null
  const void* w[2];      // weights (phases, taps, c[s], Cout) in the compute dtype; for
                         // the wgmma body their packed copy (pack_conv_weights)
  int c[2];
  const float* shift;    // (Cout)
  const void* residual;  // null or like out; may alias out
  void* out;             // (N, H * up, W * up, Cout) in the compute dtype
  int H, W, Cout;
  int ksize;             // 3: 3x3 taps, pad 1; 2: sub-pixel phases of 2x2 taps
  int relu;
  // The last layer (Cout = 3) only:
  const void* image;     // (N, H, W, 3) compute dtype
  const void* guidance;     // null (K3) or (N, H, W, gc) compute dtype
  const float* guidance_w;  // (gc) f32
  float guidance_b;
  int gc;
  float* out_f32;        // (N, H, W, 3)
};

// Whether a layer of these widths takes the wgmma body: bf16 with every
// width a multiple of 16. Everything else takes the FMA body.
bool conv_uses_wgmma(int c0, int c1, int cout, int is_bf16);

// One convolution that is not a tail's last layer, on the body that
// `conv_uses_wgmma` names. Returns cudaGetLastError().
int launch_conv(const ConvArgs& a, int N, int is_bf16, cudaStream_t stream);

// A tail's last layer (Cout = 3): the FMA body with the tanh, guidance,
// blend and clip epilogue, written as f32.
int launch_conv_final(const ConvArgs& a, int N, int is_bf16, cudaStream_t stream);

}  // namespace adam
