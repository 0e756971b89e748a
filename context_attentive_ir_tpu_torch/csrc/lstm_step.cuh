// The step route of the recurrent kernels (lstm_step.cu): the LSTM's
// kernels 1, 4, 5 above H = 1,024 and kernel 6 above H = 512, the GRU's
// kernels 7, 8, 9 above H = 1,024, in both dtypes (`lstm_route`,
// `gru_route` in lstm_mma.cuh): the entry points cair_lstm_step,
// cair_gru_step and the backwards' phase A call, and the buffers they lay
// out.

#pragma once

#include "lstm_mma.cuh"

namespace cair_lstm {

// planes a cell and step of kernel 5's recompute (i, f, g, o, c_prev,
// c_new) and of kernel 9's (h_prev, r, z, n, hn), by the gate count
constexpr int kStepSaved = 6;
constexpr int kGruStepSaved = 5;
inline int step_planes(int gates) {
  return gates == tiles::kLstmGates ? kStepSaved : kGruStepSaved;
}
// rows whose dgates one thread of the reverse pass sums into its db partial
constexpr int kDgRows = 16;

// units of a unit tile: bf16 (dtype 1) a rank of a cluster, float32 a
// float32 rank
inline int step_units(int dtype) {
  return dtype == 1 ? tiles::kStepUnits : kF32Units;
}

inline int step_unit_tiles(int h_dim, int dtype) {
  return (h_dim + step_units(dtype) - 1) / step_units(dtype);
}

// The shapes the step route takes: E >= 0 (0: kernel 6, whose accumulators
// start from x_proj), any H in float32; bf16 E a multiple of 32 and H of a
// unit tile (the wrapper zero-pads both).
inline bool step_shape_ok(int e, int h_dim, int dtype) {
  if (e < 0 || h_dim <= 0) return false;
  if (dtype == 0) return true;
  return dtype == 1 && e % tiles::kAlign == 0 && h_dim % tiles::kStepUnits == 0;
}

// Byte offsets of the forward's state (cair_lstm_step's and
// cair_gru_step's workspace): h in the compute dtype, read and written in
// turn [2, rows, H]; the LSTM's c, f32 [rows, H]; bf16 only, the f32 h
// [rows, H] (the LSTM's kernel 4 copies its boundaries out of it; the GRU
// carries h in it, since z * h reads the f32 h) -- a float32 h is the h
// buffers' own.
struct StepState {
  size_t hbuf, c, h32, total;
};

inline StepState step_state(int n_rows, int h_dim, int dtype, int gates) {
  const size_t p = (size_t)n_rows * h_dim;
  StepState L;
  size_t off = 0;
  L.hbuf = off;
  off += align256(2 * p * (dtype == 1 ? 2 : 4));
  L.c = off;
  off += gates == tiles::kLstmGates ? align256(p * 4) : 0;
  L.h32 = off;
  off += dtype == 1 ? align256(p * 4) : 0;
  L.total = off;
  return L;
}

// Kernels 1, 4 (res) and 6 (rec: x is x_proj [B, T, 4H], e = 0, b unused)
// on the step route (gates = 4, b_hh unused), or kernels 7, 8 (res; gates =
// 3, b the GRU's b_ih); arguments as cair_lstm_step's / cair_gru_step's.
int step_forward(const void* x, const void* mask, const void* w_ih,
                 const void* b, const void* b_hh, const void* w_hh, void* out,
                 void* hb, void* cb, void* workspace, int n_rows, int n_steps,
                 int e, int h_dim, int reverse, int tc, bool res, bool rec,
                 int gates, int dtype, cudaStream_t stream);

// Phase A's step-route buffers, in lstm_bwd.cu's (gru_bwd.cu's)
// workspace: h [2, rows, H] (compute dtype) of the recompute, the LSTM's c
// or bf16's f32 h of the GRU [rows, H], the planes [tc][step_planes][rows,
// H], the carried dh and the LSTM's dc or the GRU's dh' z [rows, H], the dh
// partials of the unit tiles [tiles][rows, H] (all f32 but h), the db
// partials [ceil(rows / kDgRows)][4H], and phase B's operands: the four
// gradient slots [B*T, 4H] (the LSTM's dgates; the GRU's da_r, da_z, da_n,
// da_n * r) and h_prev [B*T, H].
struct StepBwd {
  void* hbuf;
  float* c;
  float* h32;
  float* act;
  float* dh;
  float* dc;
  float* partial;
  float* db_part;
  void* dgates;
  void* h_prev;
};

// Kernel 5's (gates = 4) or kernel 9's (gates = 3; b the GRU's b_ih, cb
// unused) phase A on the step route: per chunk in reverse processing order,
// the recompute from (hb, cb), a launch a step, then the reverse pass, two
// launches a step (the gradient slots, then the dh partials).  bf16:
// `w_ih` the staged tiles, `w_hh`, `w_hh_t` not read; float32: `w_ih`,
// `w_hh` as given, `w_hh_t` [gates * H, H].
int step_phase_a(const void* x, const void* mask, const void* w_ih,
                 const void* b, const void* b_hh, const void* w_hh,
                 const void* w_hh_t, const void* hb, const void* cb,
                 const void* dout, const StepBwd& ws, int n_rows, int n_steps,
                 int e, int h_dim, int reverse, int tc, int gates, int dtype,
                 cudaStream_t stream);

}  // namespace cair_lstm
