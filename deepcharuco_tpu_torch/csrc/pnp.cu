// Planar PnP, one block a frame: the degeneracy gate, the undistortion,
// the normalised DLT homography, the pose from it and its planar twin, and
// Levenberg–Marquardt from both starts, for every frame in one launch.
//
// Replaces no TPU kernel: the JAX package solves the pose as XLA operations
// (deepcharuco_tpu/pnp/solve.py, solve_pnp). In PyTorch the same algorithm
// (pnp/solve.py, solve_pnp_plain) is about 5,400 small dependent operations
// a batch whatever the batch's size, so the card waits on their launches.
//
// Bound on an H100: latency. A frame is a few hundred thousand flops in
// chains of dependent steps (8 undistortion steps, a 9×9 Cholesky and 12
// inverse-power steps, 9 polar steps, then 20 LM iterations from each of
// two starts, each a projection of every point with its 2×6 Jacobian, a
// sum over the points and a 6×6 solve), and a batch of 256 frames reads and
// writes a few tens of KB. The card's throughput is never the limit: one
// block's chain of steps is, and every block runs at once.
//
// Design: a block of two warps a frame; a lane holds points lane, lane+32,
// ..., so any number of points works. Warp 0 computes the gate, the
// undistorted points (kept in shared memory for its later passes), AᵀA, the
// DLT's null vector (the 9×18 Cholesky of [AᵀA + jitter·I | I] one column a
// lane, then L⁻¹ on every lane and 12 inverse-power steps), the homography's
// pose and its planar twin; it leaves both starts in shared memory. Each
// warp then runs LM from one start: a lane sums its points' JᵀJ (upper
// triangle, 21), Jᵀr (6) and rᵀr, a __shfl_xor_sync butterfly gives every
// lane the same sums (each addition commutes, so the lanes agree bit for
// bit and never diverge), and every lane solves the 6×6 system itself: no
// shared memory and no barrier inside an iteration. The lower cost wins.
// Device launches per call: this kernel.
//
// Numerics: pnp/solve.py's algorithm step for step in float32, with its
// constants, fixed iteration counts (no early exit) and branches
// (torch.where becomes a select; clamps keep NaN, as torch's do), the full
// 12-coefficient distortion model on every call, precise sqrtf, acosf,
// atan2f and sincosf. Sums run in another order (lane partials, then a
// warp tree) and nvcc contracts a·b + c into fma, so the poses agree with
// the plain version within rounding, not bit for bit. One change of range,
// not of arithmetic: the inverse-power step's norm sums its squares in
// double. Where the DLT is not determined (4 points, 3 of them in line:
// AᵀA has a two-dimensional null space) rounding may clamp two pivots, the
// step's vector then reaches 1e20 and its squares would overflow a float,
// which zeroes the vector and leaves the frame a pose at z = 0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 64;       // two warps: one LM start each
constexpr int kMaxPoints = 4096;   // a float2 of shared memory a point
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kSqrt2 = static_cast<float>(1.41421356237309504880);
constexpr float kSqrt3 = static_cast<float>(1.73205080756887729353);

struct Camera {
  float fx, fy, cx, cy;
  float k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ K,
                                              const float* __restrict__ d) {
  return Camera{K[0], K[4], K[2], K[5], d[0], d[1], d[2],  d[3],
                d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11]};
}

// torch.clamp_min / clamp_max: NaN stays NaN (fminf and fmaxf drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// Every lane gets the sum of v[i] over the warp's 32 lanes.
template <int kN>
__device__ __forceinline__ void warp_sum(float (&v)[kN]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] += __shfl_xor_sync(kFull, v[i], m);
  }
}

// Index of (i, j), i <= j, in the packed upper triangle of an n×n matrix.
__host__ __device__ constexpr int upper(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// ------------------------------------------------------------ camera model

// projection.py's _distort: cv2's rational + thin-prism model at ideal
// normalised (x, y); with J also ∂(xd, yd)/∂(x, y).
template <bool kJacobian>
__device__ __forceinline__ void distort(const Camera& c, float x, float y, float& xd,
                                        float& yd, float (*J)[2] = nullptr) {
  const float vx = x * x, vy = y * y;
  const float r2 = vx + vy;
  const float num = 1.f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
  const float den = 1.f + r2 * (c.k4 + r2 * (c.k5 + r2 * c.k6));
  const float radial = num / den;
  const float xy = x * y;
  const float prism_x = c.s1 + c.s2 * r2, prism_y = c.s3 + c.s4 * r2;
  xd = x * radial + 2.f * xy * c.p1 + c.p2 * (r2 + 2.f * vx) + r2 * prism_x;
  yd = y * radial + 2.f * xy * c.p2 + c.p1 * (r2 + 2.f * vy) + r2 * prism_y;
  if (!kJacobian) return;
  const float dnum = c.k1 + r2 * (2.f * c.k2 + 3.f * c.k3 * r2);
  const float dden = c.k4 + r2 * (2.f * c.k5 + 3.f * c.k6 * r2);
  const float drad = (dnum - radial * dden) / den;
  const float ux = 2.f * (drad * x + c.p2 + prism_x + c.s2 * r2);
  const float uy = 2.f * (drad * y + c.p1 + prism_y + c.s4 * r2);
  J[0][0] = ux * x + 2.f * c.p1 * y + (radial + 4.f * c.p2 * x);
  J[0][1] = ux * y + 2.f * c.p1 * x;
  J[1][0] = uy * x + 2.f * c.p2 * y;
  J[1][1] = uy * y + 2.f * c.p2 * x + (radial + 4.f * c.p1 * y);
}

// projection.py's undistort_normalize: pixel → ideal normalised, 8 steps.
__device__ __forceinline__ void undistort(const Camera& c, float u, float v, float& x,
                                          float& y) {
  const float x0 = (u - c.cx) / c.fx, y0 = (v - c.cy) / c.fy;
  x = x0;
  y = y0;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    float dx, dy;
    distort<false>(c, x, y, dx, dy);
    x = x0 - (dx - x);
    y = y0 - (dy - y);
  }
}

// ------------------------------------------------------- 3×3 and rotations

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void matmul3(const float (*a)[3], const float (*b)[3],
                                        float (*o)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

__device__ __forceinline__ void skew(const float* v, float (*o)[3]) {
  o[0][0] = 0.f;   o[0][1] = -v[2]; o[0][2] = v[1];
  o[1][0] = v[2];  o[1][1] = 0.f;   o[1][2] = -v[0];
  o[2][0] = -v[1]; o[2][1] = v[0];  o[2][2] = 0.f;
}

__device__ __forceinline__ void column(const float (*m)[3], int j, float* o) {
  o[0] = m[0][j];
  o[1] = m[1][j];
  o[2] = m[2][j];
}

// smallmath.py's inv3: the adjugate's rows are the cross products of the
// columns; a determinant under 1e-12 in size is moved by 1e-12.
__device__ __forceinline__ void inv3(const float (*m)[3], float (*o)[3]) {
  float c0[3], c1[3], c2[3], adj[3][3];
  column(m, 0, c0);
  column(m, 1, c1);
  column(m, 2, c2);
  cross3(c1, c2, adj[0]);
  cross3(c2, c0, adj[1]);
  cross3(c0, c1, adj[2]);
  float det = dot3(c0, adj[0]);
  det = det + (fabsf(det) < kEps ? kEps : 0.f);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i][j] = adj[i][j] / det;
}

// projection.py's _rodrigues_coeffs: a = sin θ/θ, b = (1 − cos θ)/θ² and
// a'(θ)/θ, b'(θ)/θ, with the small-angle series under θ² = 1e-10.
__device__ __forceinline__ void rodrigues_coeffs(float theta2, float& a, float& b, float& da,
                                                 float& db) {
  const float theta = sqrtf(theta2 + kEps);
  const bool small = theta2 < 1e-10f;
  float s, c;
  sincosf(theta, &s, &c);
  a = small ? 1.f - theta2 / 6.f : s / theta;
  b = small ? 0.5f - theta2 / 24.f : (1.f - c) / (theta2 + kEps);
  const float theta3 = theta * theta * theta;
  da = small ? static_cast<float>(-1.0 / 3.0) : (theta * c - s) / theta3;
  db = small ? static_cast<float>(-1.0 / 12.0) : (theta * s - 2.f * (1.f - c)) / (theta3 * theta);
}

// R = I + a·[r]× + b·[r]×², with [r]× in K.
__device__ __forceinline__ void rotation(float a, float b, const float (*K)[3], float (*R)[3]) {
  float KK[3][3];
  matmul3(K, K, KK);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = ((i == j ? 1.f : 0.f) + a * K[i][j]) + b * KK[i][j];
}

__device__ __forceinline__ void rodrigues(const float* r, float (*R)[3]) {
  float a, b, da, db, K[3][3];
  rodrigues_coeffs(dot3(r, r), a, b, da, db);
  skew(r, K);
  rotation(a, b, K, R);
}

// projection.py's rodrigues_inverse, its near-0 and near-π branches included.
__device__ __forceinline__ void rodrigues_inverse(const float (*R)[3], float* out) {
  const float cos_t = clamp_max(clamp_min((R[0][0] + R[1][1] + R[2][2] - 1.f) * 0.5f, -1.f), 1.f);
  const float theta = acosf(cos_t);
  const float w[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]};
  const float g = theta / (2.f * sinf(theta) + kEps);
  const bool near_zero = theta < 1e-6f;
  const bool near_pi = kPi - theta < 1e-4f;
  const float sx = R[0][1] + R[1][0] >= 0.f ? 1.f : -1.f;
  const float sz = R[1][2] + R[2][1] >= 0.f ? 1.f : -1.f;
  float ax[3] = {sqrtf(clamp_min(R[0][0] * 0.5f + 0.5f, 0.f)) * sx,
                 sqrtf(clamp_min(R[1][1] * 0.5f + 0.5f, 0.f)) * 1.f,
                 sqrtf(clamp_min(R[2][2] * 0.5f + 0.5f, 0.f)) * sz};
  const float an = sqrtf(dot3(ax, ax)) + kEps;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float out_i = near_pi ? ax[i] / an * theta : w[i] * g;
    out[i] = near_zero ? w[i] * 0.5f : out_i;
  }
}

// smallmath.py's polar_rotation: the last column flipped if det < 0, then
// 9 Newton steps X ← ½(X + X⁻ᵀ) from X scaled to a unit-RMS column.
__device__ __forceinline__ void polar_rotation(float (*Q)[3], float (*X)[3]) {
  float c1[3], c2[3], c12[3], c0[3];
  column(Q, 0, c0);
  column(Q, 1, c1);
  column(Q, 2, c2);
  cross3(c1, c2, c12);
  const float flip = dot3(c0, c12) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) Q[i][2] = Q[i][2] * flip;
  float fro = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) fro += Q[i][j] * Q[i][j];
  const float scale = sqrtf(fro) / kSqrt3 + kEps;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) X[i][j] = Q[i][j] / scale;
#pragma unroll 1
  for (int it = 0; it < 9; ++it) {
    float Xi[3][3];
    inv3(X, Xi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) X[i][j] = 0.5f * (X[i][j] + Xi[j][i]);
  }
}

// solve.py's _pose_from_homography: H ∝ [r1 r2 t] in normalised camera
// coordinates, the board in front of the camera.
__device__ __forceinline__ void pose_from_homography(float (*H)[3], float (*R)[3], float* t) {
  const float sg = H[2][2] < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = H[i][j] * sg;
  float h1[3], h2[3], h3[3];
  column(H, 0, h1);
  column(H, 1, h2);
  column(H, 2, h3);
  const float lam = 2.f / (sqrtf(dot3(h1, h1)) + sqrtf(dot3(h2, h2)) + kEps);
  float r1[3], r2[3], r3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r1[i] = h1[i] * lam;
    r2[i] = h2[i] * lam;
    t[i] = h3[i] * lam;
  }
  cross3(r1, r2, r3);
  float Q[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Q[i][0] = r1[i];
    Q[i][1] = r2[i];
    Q[i][2] = r3[i];
  }
  polar_rotation(Q, R);
}

// solve.py's _twin_pose: the board's normal reflected across the view ray
// through its centroid; the translation is kept.
__device__ __forceinline__ void twin_rotation(const float (*R)[3], const float* t,
                                              const float* centroid, float (*R1)[3]) {
  float n[3], c[3], v[3], n2[3], axis[3];
  column(R, 2, n);
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = dot3(R[i], centroid) + t[i];
  const float cn = sqrtf(dot3(c, c)) + kEps;
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = c[i] / cn;
  const float nv = 2.f * dot3(n, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) n2[i] = nv * v[i] - n[i];
  cross3(n, n2, axis);
  const float s = sqrtf(dot3(axis, axis));
  const float cos_t = clamp_max(clamp_min(dot3(n, n2), -1.f), 1.f);
  const float theta = atan2f(s, cos_t);
  float rd[3], Rd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rd[i] = axis[i] / (s + kEps) * theta;
  rodrigues(rd, Rd);
  matmul3(Rd, R, R1);
}

// ---------------------------------------------------------- warp 0: starts

// Frame data as a lane reads it: slot k's validity, its pixel (the
// principal point where invalid, which may hold anything, NaN included)
// and its board point.
struct Frame {
  const float* img;       // (n, 2)
  const uint8_t* valid;   // (n,)
  const float* obj;       // (n, 3), shared by every frame
  int n;
};

// The gate, the DLT homography's pose and its planar twin (warp 0, every
// lane the same result). start[s] = (rvec, tvec) of start s.
__device__ void initial_poses(const Frame& f, const Camera& c, int lane, float2* xn,
                              float (*start)[6], float& n_valid, bool& gate) {
  // counts and first moments; undistorted points into shared memory
  float m1[8] = {};   // n, Σu, Σv (the gate), Σx, Σy (normalised), ΣX, ΣY, ΣZ (board)
  for (int k = lane; k < f.n; k += 32) {
    const bool v = f.valid[k] != 0;
    const float w = v ? 1.f : 0.f;
    const float u = f.img[2 * k], vv = f.img[2 * k + 1];
    float x, y;
    undistort(c, v ? u : c.cx, v ? vv : c.cy, x, y);
    xn[k] = make_float2(x, y);
    m1[0] += w;
    m1[1] += v ? u : 0.f;
    m1[2] += v ? vv : 0.f;
    m1[3] += x * w;
    m1[4] += y * w;
    m1[5] += f.obj[3 * k] * w;
    m1[6] += f.obj[3 * k + 1] * w;
    m1[7] += f.obj[3 * k + 2] * w;
  }
  warp_sum(m1);
  const float wsum = clamp_min(m1[0], 1.f);
  const float mu = m1[1] / wsum, mv = m1[2] / wsum;
  const float mx = m1[3] / wsum, my = m1[4] / wsum;
  const float centroid[3] = {m1[5] / wsum, m1[6] / wsum, m1[7] / wsum};

  // the gate's second moments; the mean distances of the two normalisations
  float m2[5] = {};
  for (int k = lane; k < f.n; k += 32) {
    const bool v = f.valid[k] != 0;
    const float w = v ? 1.f : 0.f;
    const float du = v ? f.img[2 * k] - mu : 0.f, dv = v ? f.img[2 * k + 1] - mv : 0.f;
    m2[0] += du * du;
    m2[1] += dv * dv;
    m2[2] += du * dv;
    const float ex = xn[k].x - mx, ey = xn[k].y - my;
    m2[3] += sqrtf(ex * ex + ey * ey + kEps) * w;
    const float eX = f.obj[3 * k] - centroid[0], eY = f.obj[3 * k + 1] - centroid[1];
    m2[4] += sqrtf(eX * eX + eY * eY + kEps) * w;
  }
  warp_sum(m2);
  const float cxx = m2[0] / wsum, cyy = m2[1] / wsum, cxy = m2[2] / wsum;
  const float tr = cxx + cyy, det = cxx * cyy - cxy * cxy;
  const float min_eig = tr / 2.f - sqrtf(clamp_min(tr * tr / 4.f - det, 0.f));
  n_valid = m1[0];
  gate = m1[0] >= 4.f && min_eig > 1.f;
  // Hartley normalisations: p·s + o
  const float si = kSqrt2 * (1.f / clamp_min(m2[3] / wsum, kEps));
  const float so = kSqrt2 * (1.f / clamp_min(m2[4] / wsum, kEps));
  const float oix = -si * mx, oiy = -si * my;
  const float oox = -so * centroid[0], ooy = -so * centroid[1];

  // AᵀA of the masked 2n×9 DLT system, its upper triangle packed
  float ata[45] = {};
  for (int k = lane; k < f.n; k += 32) {
    const float w = f.valid[k] != 0 ? 1.f : 0.f;
    const float X = f.obj[3 * k] * so + oox, Y = f.obj[3 * k + 1] * so + ooy;
    const float x = xn[k].x * si + oix, y = xn[k].y * si + oiy;
    const float r1[9] = {X * w, Y * w, w, 0.f, 0.f, 0.f, -x * X * w, -x * Y * w, -x * w};
    const float r2[9] = {0.f, 0.f, 0.f, X * w, Y * w, w, -y * X * w, -y * Y * w, -y * w};
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = i; j < 9; ++j) {
        ata[upper(i, j, 9)] += r1[i] * r1[j];
        ata[upper(i, j, 9)] += r2[i] * r2[j];
      }
  }
  warp_sum(ata);

  // smallmath.py's smallest_eigvec: [AᵀA + jitter·I | I] = [Lᵀ | L⁻¹] by the
  // clamped right-looking Cholesky, lane k holding column k (lanes 0..17)
  float scale = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) scale += ata[upper(i, i, 9)];
  const float jitter = 1e-9f * (scale / 9.f + kEps);
  float col[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (lane == k) a = ata[i <= k ? upper(i, k, 9) : upper(k, i, 9)] + (i == k ? jitter : 0.f);
    col[i] = lane < 9 ? a : (lane - 9 == i ? 1.f : 0.f);
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float pivot = sqrtf(clamp_min(__shfl_sync(kFull, col[j], j), kEps));
    if (lane == j) col[j] = pivot;
    if (lane > j) col[j] = col[j] / pivot;
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      const float mji = __shfl_sync(kFull, col[j], i);   // row j of Lᵀ, after lane i's division
      if (lane > j) col[i] -= mji * col[j];
    }
  }
  float Linv[9][9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int m = 0; m < 9; ++m) Linv[i][m] = __shfl_sync(kFull, col[i], 9 + m);
  float h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = static_cast<float>(1.0 / 3.0);   // 1/√9
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    float y[9], z[9];
    double zz = 0.0;    // with two pivots clamped z reaches 1e20: z² overflows a float
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      y[i] = 0.f;
#pragma unroll
      for (int m = 0; m < 9; ++m) y[i] += Linv[i][m] * h[m];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      z[k] = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) z[k] += Linv[i][k] * y[i];
      zz += static_cast<double>(z[k]) * z[k];
    }
    const float nz = static_cast<float>(sqrt(zz)) + kEps;
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = z[k] / nz;
  }

  // H = T_img⁻¹ · Hn · T_obj, scaled to H[2][2] = 1
  const float Ti[3][3] = {{si, 0.f, oix}, {0.f, si, oiy}, {0.f, 0.f, 1.f}};
  const float To[3][3] = {{so, 0.f, oox}, {0.f, so, ooy}, {0.f, 0.f, 1.f}};
  const float Hn[3][3] = {{h[0], h[1], h[2]}, {h[3], h[4], h[5]}, {h[6], h[7], h[8]}};
  float Tinv[3][3], HT[3][3], H[3][3];
  inv3(Ti, Tinv);
  matmul3(Hn, To, HT);
  matmul3(Tinv, HT, H);
  const float h22 = fabsf(H[2][2]) > kEps ? H[2][2] : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = H[i][j] / h22;

  float R0[3][3], R1[3][3], t[3];
  pose_from_homography(H, R0, t);
  twin_rotation(R0, t, centroid, R1);
  rodrigues_inverse(R0, start[0]);
  rodrigues_inverse(R1, start[1]);
#pragma unroll
  for (int i = 0; i < 3; ++i) start[0][3 + i] = start[1][3 + i] = t[i];
}

// ------------------------------------------------------------- each warp: LM

// The masked reprojection problem linearised at pose p = (rvec, tvec):
// s = (JᵀJ's upper triangle (21), Jᵀr (6), rᵀr), summed over the frame's
// points and held by every lane of the warp.
__device__ void linearize(const float* p, const Frame& f, const Camera& c, int lane,
                          float (&s)[28]) {
  float a, b, da, db, Kx[3][3], R[3][3];
  rodrigues_coeffs(dot3(p, p), a, b, da, db);
  skew(p, Kx);
  rotation(a, b, Kx, R);
#pragma unroll
  for (int i = 0; i < 28; ++i) s[i] = 0.f;
  for (int k = lane; k < f.n; k += 32) {
    const bool v = f.valid[k] != 0;
    const float w = v ? 1.f : 0.f;
    const float qu = v ? f.img[2 * k] : c.cx, qv = v ? f.img[2 * k + 1] : c.cy;
    const float X[3] = {f.obj[3 * k], f.obj[3 * k + 1], f.obj[3 * k + 2]};
    float cam[3], KX[3], KKX[3], SX[3][3], SKX[3][3], KSX[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) cam[i] = dot3(X, R[i]) + p[3 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) KX[i] = dot3(Kx[i], X);
#pragma unroll
    for (int i = 0; i < 3; ++i) KKX[i] = dot3(Kx[i], KX);
    skew(X, SX);
    skew(KX, SKX);
    matmul3(Kx, SX, KSX);
    float dcam[3][3];   // ∂cam/∂rvec
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dcam[i][j] = -(a * SX[i][j]) - b * (SKX[i][j] + KSX[i][j]) + KX[i] * (da * p[j]) +
                     KKX[i] * (db * p[j]);
    const float z = cam[2], zc = clamp_min(z, kEps);
    const float xn = cam[0] / zc, yn = cam[1] / zc;
    const float iz = 1.f / zc;
    const float dz = z > kEps ? -iz : 0.f;   // the clamp passes no derivative below it
    const float dxn[2][3] = {{iz, 0.f, xn * dz}, {0.f, iz, yn * dz}};
    float xd, yd, Jd[2][2];
    distort<true>(c, xn, yn, xd, yd, Jd);
    const float fc[2] = {c.fx, c.fy};
    float J[2][6];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float P[3];   // ∂pixel_i/∂cam
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) P[k2] = Jd[i][0] * fc[i] * dxn[0][k2] + Jd[i][1] * fc[i] * dxn[1][k2];
#pragma unroll
      for (int j = 0; j < 3; ++j) J[i][j] = (P[0] * dcam[0][j] + P[1] * dcam[1][j] + P[2] * dcam[2][j]) * w;
#pragma unroll
      for (int j = 0; j < 3; ++j) J[i][3 + j] = P[j] * w;
    }
    const float r[2] = {(xd * c.fx + c.cx - qu) * w, (yd * c.fy + c.cy - qv) * w};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        s[upper(i, j, 6)] += J[0][i] * J[0][j];
        s[upper(i, j, 6)] += J[1][i] * J[1][j];
      }
      s[21 + i] += J[0][i] * r[0];
      s[21 + i] += J[1][i] * r[1];
    }
    s[27] += r[0] * r[0];
    s[27] += r[1] * r[1];
  }
  warp_sum(s);
}

// smallmath.py's cholesky_solve on the augmented 6×7 [A | b]: the clamped
// factor with the forward substitution in the same pass, then the backward.
__device__ __forceinline__ void solve6(float (*M)[7], float* x) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    M[j][j] = sqrtf(clamp_min(M[j][j], kEps));
#pragma unroll
    for (int k = j + 1; k < 7; ++k) M[j][k] = M[j][k] / M[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i)
#pragma unroll
      for (int k = i; k < 7; ++k) M[i][k] -= M[j][i] * M[j][k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = M[i][6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    x[i] = x[i] / M[i][i];
#pragma unroll
    for (int m = 0; m < i; ++m) x[m] -= M[m][i] * x[i];
  }
}

// solve.py's _lm_refine from p: `iters` damped Gauss–Newton steps, each
// accepted if it lowers the cost. Returns the cost at the final p.
__device__ float levenberg_marquardt(float* p, int iters, const Frame& f, const Camera& c,
                                     int lane) {
  float s[28];
  linearize(p, f, c, lane, s);
  float lam = 1e-3f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float M[6][7], delta[6], q[6], sq[28];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) M[i][j] = s[upper(i, j, 6)];
      M[i][i] = M[i][i] + lam * (M[i][i] + 1e-12f);
      M[i][6] = s[21 + i];
    }
    solve6(M, delta);
#pragma unroll
    for (int i = 0; i < 6; ++i) q[i] = p[i] - delta[i];
    linearize(q, f, c, lane, sq);
    const bool better = sq[27] < s[27];   // the same on every lane
#pragma unroll
    for (int i = 0; i < 6; ++i) p[i] = better ? q[i] : p[i];
#pragma unroll
    for (int i = 0; i < 28; ++i) s[i] = better ? sq[i] : s[i];
    lam = better ? clamp_min(lam * 0.3f, 1e-12f) : clamp_max(lam * 4.f, 1e8f);
  }
  return s[27];
}

__global__ void __launch_bounds__(kThreads)
pnp_kernel(const float* __restrict__ img, const uint8_t* __restrict__ valid,
           const float* __restrict__ obj, const float* __restrict__ K,
           const float* __restrict__ dist, int n, int iters, bool* __restrict__ ok,
           float* __restrict__ rvec, float* __restrict__ tvec, float* __restrict__ rms) {
  extern __shared__ float2 xn[];   // warp 0's undistorted points
  __shared__ float starts[2][6];
  __shared__ float ends[2][7];     // (rvec, tvec, cost) from each start
  __shared__ float gate_s[2];      // the gate, the number of valid points
  const int frame = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Frame f{img + 2ll * frame * n, valid + static_cast<long long>(frame) * n, obj, n};
  const Camera c = load_camera(K, dist);
  if (warp == 0) {
    float st[2][6], n_valid;
    bool gate;
    initial_poses(f, c, lane, xn, st, n_valid, gate);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        starts[0][i] = st[0][i];
        starts[1][i] = st[1][i];
      }
      gate_s[0] = gate ? 1.f : 0.f;
      gate_s[1] = n_valid;
    }
  }
  __syncthreads();
  float p[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i] = starts[warp][i];
  const float cost = levenberg_marquardt(p, iters, f, c, lane);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) ends[warp][i] = p[i];
    ends[warp][6] = cost;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  // solve.py: the homography's start wins ties; then _finish
  const float* e = ends[ends[0][6] <= ends[1][6] ? 0 : 1];
  const float rm = sqrtf(e[6] / clamp_min(gate_s[1], 1.f));
  bool good = gate_s[0] != 0.f && isfinite(rm);
#pragma unroll
  for (int i = 0; i < 6; ++i) good = good && isfinite(e[i]);
  ok[frame] = good;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rvec[3 * frame + i] = good ? e[i] : 0.f;
    tvec[3 * frame + i] = good ? e[3 + i] : 0.f;
  }
  rms[frame] = good ? rm : INFINITY;
}

}  // namespace

// img (m, n, 2) f32, valid (m, n) bool, obj (n, 3) f32, K (3, 3) f32 and
// dist (12) f32 (cv2's order, zero-padded), all contiguous on one card;
// n up to 4096; ok (m) bool, rvec and tvec (m, 3) f32, rms (m) f32.
// Returns cudaGetLastError().
extern "C" int dc_pnp(const void* img, const void* valid, const void* obj, const void* K,
                      const void* dist, int m, int n, int iters, void* ok, void* rvec,
                      void* tvec, void* rms, void* stream) {
  if (m < 0 || n < 0 || n > kMaxPoints || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float2) * static_cast<size_t>(n);
  pnp_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(obj), static_cast<const float*>(K),
      static_cast<const float*>(dist), n, iters, static_cast<bool*>(ok),
      static_cast<float*>(rvec), static_cast<float*>(tvec), static_cast<float*>(rms));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
