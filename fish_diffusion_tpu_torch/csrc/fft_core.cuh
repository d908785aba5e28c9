// K5's FFT core, shared by stft.cu (the STFT magnitude and its backward)
// and istft.cu (the inverse STFT): complex arithmetic on float or double
// pairs; a Stockham auto-sort FFT in shared memory (radix 8, then 4 or 2
// for the last bits) over a buffer skewed by one element in eight (pad);
// Bluestein's chirp-z transform on the same core for any other length
// (transform / spectrum); a block-wide maximum (for each frame's scale);
// and the four-step FFT through device memory for lengths past shared
// memory (split_transform: A, or for Bluestein A, the filter, then B; see
// stft.cu). Only plain C++ over threadIdx / blockIdx / blockDim, shared
// memory and __syncthreads, so tests/test_torch_csrc_emulated.py runs it on
// the host. Include after <cuda_runtime.h>.

#ifndef FDT_FFT_CORE_CUH
#define FDT_FFT_CORE_CUH

namespace {  // internal linkage: each library keeps its own copy


constexpr int MAX_SMEM = 232448;  // an H100 block's shared memory
constexpr int MAX_L = 16384;      // Bluestein at n_fft 8192

template <class T>
struct alignas(2 * sizeof(T)) cplx {
  T x, y;
};
using cf = cplx<float>;
using cd = cplx<double>;

template <class T>
__device__ __forceinline__ cplx<T> cmul(cplx<T> a, cplx<T> b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
template <class T>
__device__ __forceinline__ cplx<T> cconj(cplx<T> a) { return {a.x, -a.y}; }
template <class T>
__device__ __forceinline__ cplx<T> cadd(cplx<T> a, cplx<T> b) {
  return {a.x + b.x, a.y + b.y};
}
template <class T>
__device__ __forceinline__ cplx<T> csub(cplx<T> a, cplx<T> b) {
  return {a.x - b.x, a.y - b.y};
}
// -i a and +i a
template <class T>
__device__ __forceinline__ cplx<T> cmi(cplx<T> a) { return {a.y, -a.x}; }
template <class T>
__device__ __forceinline__ cplx<T> cpi(cplx<T> a) { return {-a.y, a.x}; }
template <class T>
__device__ __forceinline__ cplx<T> cscale(cplx<T> a, T s) { return {a.x * s, a.y * s}; }
template <class T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <class T>
__device__ __forceinline__ T tabs(T a) { return a < 0 ? -a : a; }
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double tsqrt(double a) { return sqrt(a); }

// The power of two s = 2^e > m (1 for m = 0) and 1 / s: scaling by either
// is exact.
__device__ __forceinline__ void pow2_above(float m, float& s, float& inv) {
  int e;
  frexpf(m, &e);
  s = ldexpf(1.f, e);
  inv = ldexpf(1.f, -e);
}
__device__ __forceinline__ void pow2_above(double m, double& s, double& inv) {
  int e;
  frexp(m, &e);
  s = ldexp(1.0, e);
  inv = ldexp(1.0, -e);
}

// the shared buffer's slot of element i: one pad element after every eight
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 3); }
__host__ __device__ __forceinline__ int buf_size(int L) { return L + L / 8 + 1; }

// the 4-point DFT in place (forward sign)
template <class T>
__device__ __forceinline__ void dft4(cplx<T>& a0, cplx<T>& a1, cplx<T>& a2, cplx<T>& a3) {
  const cplx<T> t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const cplx<T> t2 = cadd(a1, a3), t3 = csub(a1, a3);
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, cmi(t3));
  a3 = cadd(t1, cpi(t3));
}

template <int R, class T>
__device__ __forceinline__ void butterfly(cplx<T>* v) {
  if constexpr (R == 2) {
    const cplx<T> t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {  // 8 = 2 x 4: even and odd inputs, then the W8^q merge
    const T H = (T)0.70710678118654752440;
    cplx<T> e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    cplx<T> o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    o1 = {H * (o1.x + o1.y), H * (o1.y - o1.x)};   // x W8 = (1 - i) / sqrt 2
    o2 = cmi(o2);                                   // x W8^2 = -i
    o3 = {H * (o3.y - o3.x), -H * (o3.x + o3.y)};  // x W8^3 = -(1 + i) / sqrt 2
    v[0] = cadd(e0, o0); v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1); v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2); v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3); v[7] = csub(e3, o3);
  }
}

// One Stockham pass of radix R over buf[0, L), sub-transform length p:
// butterfly j reads x[j + r L/R], twiddles it by W_L^{r k L/(p R)} with
// k = j mod p, and writes its outputs to (j - k) R + k + r p. Every thread
// holds at most V values (blockDim.x >= L / V), read before the barrier
// and written after it.
template <int R, int V, class T>
__device__ __forceinline__ void fft_pass(cplx<T>* buf, int L, int p,
                                         const cplx<T>* __restrict__ tw) {
  constexpr int PER = V / R;
  static_assert(PER >= 1, "a thread holds at least one butterfly");
  const int nb = L / R;
  cplx<T> v[PER][R];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nb) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[i][r] = buf[pad(j + r * nb)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nb) {
      const int k = j & (p - 1);
      const int ts = k * (nb / p);
      if constexpr (R == 8) {  // three loads; the rest one or two products
        const cplx<T> w1 = tw[ts], w2 = tw[2 * ts], w4 = tw[4 * ts];
        const cplx<T> w3 = cmul(w1, w2);
        v[i][1] = cmul(v[i][1], w1);
        v[i][2] = cmul(v[i][2], w2);
        v[i][3] = cmul(v[i][3], w3);
        v[i][4] = cmul(v[i][4], w4);
        v[i][5] = cmul(v[i][5], cmul(w1, w4));
        v[i][6] = cmul(v[i][6], cmul(w2, w4));
        v[i][7] = cmul(v[i][7], cmul(w3, w4));
      } else {
#pragma unroll
        for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], tw[r * ts]);
      }
      butterfly<R>(v[i]);
      const int o = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[pad(o + r * p)] = v[i][r];
    }
  }
  __syncthreads();
}

// The forward FFT of buf[0, L) in place, natural order in and out, from
// sub-transform length p on (the passes before done).
template <int V, class T>
__device__ __forceinline__ void fft(cplx<T>* buf, int L, const cplx<T>* __restrict__ tw,
                                    int p = 1) {
  while (p < L) {
    const int left = L / p;
    if (left >= 8) {
      fft_pass<8, V>(buf, L, p, tw);
      p *= 8;
    } else if (left == 4) {
      fft_pass<4, V>(buf, L, p, tw);
      p *= 4;
    } else {
      fft_pass<2, V>(buf, L, p, tw);
      p *= 2;
    }
  }
}

// The N-point DFT of what buf holds (already chirped and zero-padded to L
// for Bluestein; its FFT's passes done up to sub-transform length p0).
// Afterwards element k of the DFT is spectrum(buf, k).
template <int V, class T>
__device__ __forceinline__ void transform(cplx<T>* buf, int L, const cplx<T>* __restrict__ tw,
                                          const cplx<T>* __restrict__ filt, int p0 = 1) {
  fft<V>(buf, L, tw, p0);
  if (filt) {
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      const int s = pad(k);
      buf[s] = cconj(cmul(buf[s], filt[k]));
    }
    __syncthreads();
    fft<V>(buf, L, tw);  // conj of the convolution
  }
}

template <class T>
__device__ __forceinline__ cplx<T> spectrum(const cplx<T>* buf, int k,
                                            const cplx<T>* __restrict__ chirp) {
  const cplx<T> z = buf[pad(k)];
  return chirp ? cmul(chirp[k], cconj(z)) : z;
}

// The block-wide maxima of a.x and of a.y, returned to every thread: each
// thread's pair in red[t], 32 partial maxima in red[T + i], read by all.
// red holds blockDim.x + 32 values; two barriers.
template <class T>
__device__ __forceinline__ cplx<T> block_max(cplx<T> a, cplx<T>* red) {
  const int nt = blockDim.x, t = threadIdx.x;
  red[t] = a;
  __syncthreads();
  if (t < 32) {
    cplx<T> m = {0, 0};
    for (int i = t; i < nt; i += 32) m = {tmax(m.x, red[i].x), tmax(m.y, red[i].y)};
    red[nt + t] = m;
  }
  __syncthreads();
  cplx<T> m = red[nt];
  for (int i = 1; i < 32; ++i) m = {tmax(m.x, red[nt + i].x), tmax(m.y, red[nt + i].y)};
  return m;
}

// Shared memory above 48 KB needs the kernel's attribute, set once.
template <class K>
void allow_smem(K kernel, bool& done) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_SMEM);
    done = true;
  }
}

// ---------------------------------------------------------------------------
// The split path: four-step FFTs through device memory
// ---------------------------------------------------------------------------

constexpr int MAX_SUB = 2048;        // the largest L1 or L2
constexpr int SPLIT_T = 512;         // threads of the per-pair kernels
constexpr int MAX_L_SPLIT = MAX_SUB * MAX_SUB;

// the position of X[k] after transform A
__host__ __device__ __forceinline__ size_t pos_a(int k, int L1, int L2) {
  return (size_t)(k % L1) * L2 + k / L1;
}

// One L1-point FFT of column c (stride L2) or one L2-point FFT of row r of
// pair blockIdx.x's buffer, in place; optionally times W_L^(line * k) after.
// Shared memory: the padded buffer, then the S-point twiddles.
template <class T, bool COLUMN, bool TWIDDLE>
__global__ void __launch_bounds__(MAX_SUB / 8) split_pass(
    cplx<T>* __restrict__ work, const cplx<T>* __restrict__ tw, int L1, int L2) {
  extern __shared__ float smem_split[];
  const int S = COLUMN ? L1 : L2;
  cplx<T>* buf = reinterpret_cast<cplx<T>*>(smem_split);
  cplx<T>* tws = buf + buf_size(S);
  const int L = L1 * L2;
  const int line = blockIdx.y;
  cplx<T>* base = work + (size_t)blockIdx.x * L + (COLUMN ? line : (size_t)line * L2);
  const size_t stride = COLUMN ? L2 : 1;
  const int tw_stride = L / S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    buf[pad(i)] = base[i * stride];
    tws[i] = tw[(size_t)i * tw_stride];
  }
  __syncthreads();
  fft<8>(buf, S, tws);
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    cplx<T> v = buf[pad(k)];
    if (TWIDDLE) v = cmul(v, tw[(size_t)line * k]);
    base[k * stride] = v;
  }
}

// Pointwise conj(X[k] filt[k]) over the pairs' buffers after transform A
// (position p holds X[p / L2 + L1 (p mod L2)]).
template <class T>
__global__ void split_filter(cplx<T>* __restrict__ work, const cplx<T>* __restrict__ filt,
                             int L1, int L2, size_t total) {
  const size_t L = (size_t)L1 * L2;
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t p = i % L;
  const int k = (int)(p / L2) + L1 * (int)(p % L2);
  work[i] = cconj(cmul(work[i], filt[k]));
}

// The N-point DFT of what a pair's buffer held (after the transforms),
// element k: transposed order for a power of two, natural for Bluestein
// (with the output chirp).
template <class T>
__device__ __forceinline__ cplx<T> split_spectrum(const cplx<T>* buf, int k,
                                                  const cplx<T>* __restrict__ chirp,
                                                  int L1, int L2) {
  if (chirp) return cmul(chirp[k], cconj(buf[k]));
  return buf[pos_a(k, L1, L2)];
}

// The L-point transform of every pair's buffer: A, or for Bluestein A,
// the filter, then B. Returns the cudaError_t of the launches.
template <class T>
int split_transform(cplx<T>* work, const cplx<T>* tw, const cplx<T>* filt, int pairs, int L1,
                    int L2, cudaStream_t s) {
  static bool done[4] = {false, false, false, false};
  allow_smem(split_pass<T, true, true>, done[0]);
  allow_smem(split_pass<T, false, false>, done[1]);
  allow_smem(split_pass<T, false, true>, done[2]);
  allow_smem(split_pass<T, true, false>, done[3]);
  const dim3 cols(pairs, L2), rows(pairs, L1);
  const int t1 = L1 / 8 < 64 ? 64 : L1 / 8, t2 = L2 / 8 < 64 ? 64 : L2 / 8;
  const int s1 = (buf_size(L1) + L1) * (int)sizeof(cplx<T>);
  const int s2 = (buf_size(L2) + L2) * (int)sizeof(cplx<T>);
  split_pass<T, true, true><<<cols, t1, s1, s>>>(work, tw, L1, L2);
  split_pass<T, false, false><<<rows, t2, s2, s>>>(work, tw, L1, L2);
  if (filt) {
    const size_t total = (size_t)pairs * L1 * L2;
    const int blocks = (int)((total + 255) / 256);
    split_filter<T><<<blocks, 256, 0, s>>>(work, filt, L1, L2, total);
    split_pass<T, false, true><<<rows, t2, s2, s>>>(work, tw, L1, L2);
    split_pass<T, true, false><<<cols, t1, s1, s>>>(work, tw, L1, L2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#endif  // FDT_FFT_CORE_CUH
