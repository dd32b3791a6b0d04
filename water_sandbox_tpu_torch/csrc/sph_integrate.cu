// The integrate phase in one launch: the interaction field's acceleration,
// the velocity update, the speed clamp, the position update, the collision
// against the box posed at t_new (in the box's frame, against the
// wall-relative velocity) and the prediction, for every row.
//
// Replaces no TPU kernel: the JAX package leaves the integrator to XLA
// (water_sandbox_tpu/ops/integrate.py::integrate, fused into one loop). It
// takes the place of the port's ATen chain for the same step,
// ops/integrate.py::integrate_plain, some 160 elementwise launches over the
// (n, dim) columns, and must equal it bit for bit.
//
// What bounds it on the H100: bytes. A row reads pos, vel and acc and
// writes pos, vel and predicted: 18 f32 in 3-D, 19.2 MB at the flagship's
// 266,112 rows (5.7 us at 3.35 TB/s). The chain it replaces ran at 60-200x
// that, bound by its launches and the gaps between them.
//
// Design.
// * One thread a row, every intermediate in registers. The parameters are
//   read through device pointers to the SimParams leaves and t_new, so a
//   captured graph sees what Simulation.tune copies into them.
// * The inputs are read through their row and column strides: in the sorted
//   step pos and vel are column slices of the build's sorted rows and acc a
//   transposed gather, and no copy is made of them.
// * The same bits as the chain. Every product and sum is rounded on its own
//   (__fmul_rn, __fadd_rn, __fsub_rn: nvcc would otherwise contract a*b+c
//   into an FMA), in the chain's order; divisions are IEEE (__fdiv_rn),
//   sqrtf, rsqrtf, cosf and sinf are the functions ATen's kernels call, and
//   the selects and clamps keep ATen's NaN rules (clamp_min and clamp return
//   a NaN input; clamp then a NaN bound). Nothing is skipped where it would
//   change a bit: a zero-strength field is computed and added all the same.

#include "sph_common.cuh"

namespace wst {

// The SimParams leaves the integrator reads, and t_new, as device pointers
// (host order: ops/cuda/integrate.py::_leaves).
struct IntegrateParams {
  const float* dt;
  const float* gravity;           // (DIM,)
  const float* max_speed;
  const float* lookahead;
  const float* particle_radius;
  const float* collision_damping;
  const float* center;            // container, (DIM,)
  const float* velocity;          // container, (DIM,)
  const float* angle;
  const float* angular_velocity;
  const float* half_size;         // container, (DIM,)
  const float* field_position;    // (DIM,)
  const float* field_strength;
  const float* field_radius;
  const float* t_new;
};
constexpr int kLeaves = 15;

// A strided (n, DIM) f32 input.
struct Rows {
  const float* p;
  int row;
  int col;
  __device__ float at(long long i, int a) const {
    return __ldg(p + i * row + static_cast<long long>(a) * col);
  }
};

// ATen's clamp_min against a scalar: a NaN input is returned.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ATen's clamp against two tensors: a NaN input, then a NaN bound, is
// returned.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// integrate.py::_rotate_yaw_axes with s already negated for the inverse:
// about +z in 2-D, +y in 3-D.
template <int DIM>
__device__ __forceinline__ void rotate(float* x, float c, float s) {
  const float x0 = x[0];
  if (DIM == 2) {
    x[0] = __fsub_rn(__fmul_rn(c, x0), __fmul_rn(s, x[1]));
    x[1] = __fadd_rn(__fmul_rn(s, x0), __fmul_rn(c, x[1]));
  } else {
    x[0] = __fadd_rn(__fmul_rn(c, x0), __fmul_rn(s, x[2]));
    x[2] = __fadd_rn(__fmul_rn(-s, x0), __fmul_rn(c, x[2]));
  }
}

template <int DIM>
__global__ void __launch_bounds__(kBlock) sph_integrate_kernel(
    Rows pos_in, Rows vel_in, Rows acc_in, IntegrateParams p,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    float* __restrict__ pred_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x[DIM], v[DIM], acc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    x[a] = pos_in.at(i, a);
    v[a] = vel_in.at(i, a);
    acc[a] = acc_in.at(i, a);
  }
  const float dt = __ldg(p.dt);

  // field_acceleration_axes
  float disp[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    disp[a] = __fsub_rn(x[a], __ldg(p.field_position + a));
  }
  float r2 = __fmul_rn(disp[0], disp[0]);
#pragma unroll
  for (int a = 1; a < DIM; ++a) {
    r2 = __fadd_rn(r2, __fmul_rn(disp[a], disp[a]));
  }
  const float r = sqrtf(r2);
  const bool away = r > 0.0f;
  const float safe_r = away ? r : 1.0f;
  const float falloff =
      clamp_min(__fsub_rn(1.0f, __fdiv_rn(r, __ldg(p.field_radius))), 0.0f);
  const float scale = __fmul_rn(__ldg(p.field_strength), falloff);

  // the velocity update
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float fa =
        __fmul_rn(away ? __fdiv_rn(disp[a], safe_r) : 0.0f, scale);
    const float g =
        __fadd_rn(__fadd_rn(__ldg(p.gravity + a), acc[a]), fa);
    v[a] = __fadd_rn(v[a], __fmul_rn(g, dt));
  }

  // the speed clamp: max_speed 0 turns it off
  float speed2 = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int a = 1; a < DIM; ++a) {
    speed2 = __fadd_rn(speed2, __fmul_rn(v[a], v[a]));
  }
  const float limit = __ldg(p.max_speed);
  const bool over = (limit > 0.0f) && (speed2 > __fmul_rn(limit, limit));
  const float cut =
      over ? __fmul_rn(limit,
                       rsqrtf(clamp_min(speed2, static_cast<float>(1e-30))))
           : 1.0f;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    v[a] = __fmul_rn(v[a], cut);
    x[a] = __fadd_rn(x[a], __fmul_rn(v[a], dt));
  }

  // collide_container_axes: the box posed at t_new
  const float t = __ldg(p.t_new);
  const float w = __ldg(p.angular_velocity);
  const float angle = __fadd_rn(__ldg(p.angle), __fmul_rn(w, t));
  float center[DIM], rel[DIM], box_v[DIM], wall[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    box_v[a] = __ldg(p.velocity + a);
    center[a] = __fadd_rn(__ldg(p.center + a), __fmul_rn(box_v[a], t));
    rel[a] = __fsub_rn(x[a], center[a]);
  }
  if (DIM == 2) {
    wall[0] = __fadd_rn(box_v[0], __fmul_rn(w, -rel[1]));
    wall[1] = __fadd_rn(box_v[1], __fmul_rn(w, rel[0]));
  } else {
    // omega = (0, w, 0); omega x r = (w * r_z, 0, -w * r_x)
    wall[0] = __fadd_rn(box_v[0], __fmul_rn(w, rel[2]));
    wall[1] = __fadd_rn(box_v[1], 0.0f);
    wall[2] = __fadd_rn(box_v[2], __fmul_rn(w, -rel[0]));
  }
  const float c = cosf(angle);
  const float s = sinf(angle);
  float lv[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) lv[a] = __fsub_rn(v[a], wall[a]);
  rotate<DIM>(rel, c, -s);
  rotate<DIM>(lv, c, -s);
  const float pad = __ldg(p.particle_radius);
  const float flip = -__ldg(p.collision_damping);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float half = __ldg(p.half_size + a);
    const float lo = __fadd_rn(-half, pad);
    const float hi = __fsub_rn(half, pad);
    const bool hit = (rel[a] < lo) || (rel[a] > hi);
    rel[a] = clamp(rel[a], lo, hi);
    if (hit) lv[a] = __fmul_rn(lv[a], flip);
  }
  rotate<DIM>(rel, c, s);
  rotate<DIM>(lv, c, s);

  // the state out and the prediction
  const float look = __ldg(p.lookahead);
  const long long o = static_cast<long long>(i) * DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float xa = __fadd_rn(rel[a], center[a]);
    const float va = __fadd_rn(lv[a], wall[a]);
    pos_out[o + a] = xa;
    vel_out[o + a] = va;
    pred_out[o + a] = __fadd_rn(xa, __fmul_rn(va, look));
  }
}

}  // namespace wst

// pos, vel, acc: (n, dim) f32 read at element (i, a) = base[i * row + a *
// col], each with its own strides; leaves: a host array of the 15 device
// pointers of IntegrateParams, in its order; pos_out, vel_out, pred_out:
// (n, dim) f32, contiguous. Launches on `stream` of `device` and returns
// cudaGetLastError().
extern "C" int wst_sph_integrate(const float* pos, int pos_row, int pos_col,
                                 const float* vel, int vel_row, int vel_col,
                                 const float* acc, int acc_row, int acc_col,
                                 const float* const* leaves, float* pos_out,
                                 float* vel_out, float* pred_out, int n,
                                 int dim, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const float* l[wst::kLeaves];
  for (int k = 0; k < wst::kLeaves; ++k) l[k] = leaves[k];
  const wst::IntegrateParams p{l[0], l[1], l[2], l[3], l[4],
                               l[5], l[6], l[7], l[8], l[9],
                               l[10], l[11], l[12], l[13], l[14]};
  const wst::Rows x{pos, pos_row, pos_col};
  const wst::Rows v{vel, vel_row, vel_col};
  const wst::Rows a{acc, acc_row, acc_col};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n + wst::kBlock - 1) / wst::kBlock));
  if (dim == 3) {
    wst::sph_integrate_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        x, v, a, p, pos_out, vel_out, pred_out, n);
  } else if (dim == 2) {
    wst::sph_integrate_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        x, v, a, p, pos_out, vel_out, pred_out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
