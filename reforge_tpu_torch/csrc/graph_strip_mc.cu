// graph_strip_mc: a whole multi-stage graph (the mc tier) in one pass.
//
// Replaces pallas_ops.graph_strip_fused_mc / _graph_strip_kernel_mc.  The
// TPU kernel streamed channel-full whole-width strips through VMEM with a
// DMA double buffer, carried conv rows from strip to strip and ran heavy
// convs as MXU band matmuls.  None of that carries over: here a block owns
// one (TH x TW) output tile with all four channels.
//
//   * Stages run in topological order.  Each computes its output over the
//     tile plus its own extent (eh, ew) -- what its consumers read around
//     the tile -- into a shared-memory pool slot, or, for the final node,
//     straight to device memory.
//   * Inputs.  A conv stage of the kernel input reads its own window of
//     each channel from device memory (the tile plus the stage's extent
//     plus its radii), one channel at a time: into two buffers, the next
//     channel's copy in flight while the block convolves this one, or,
//     where one buffer buys a larger tile, into one, each copy in flight
//     beside the W pass of the channel before.  The
//     four-channel input block holds only what the other stages read
//     around the tile (the demo's sharpen: one pixel, not the blur's 24).
//     Both load as conv_tile.cuh's windows do: rows from a multiple of 8
//     columns, 16 bytes a thread (cp.async for f32) where the window lies
//     in the image, else element by element through the clamped
//     coordinate.
//   * Borders.  Per-node execution edge-pads every intermediate.  A stage
//     emits only the pixels of its block that lie in the image; in a block
//     that crosses the image's edge it then fills the slot's other cells
//     with the clamped edge values, as the input's clamped load already
//     does.  Every consumer then reads shared memory unclamped, and the
//     value it reads at an outside pixel is the clamped pixel's: one code
//     path for every block.  No stage computes a value at an outside
//     pixel, except a conv's H pass at outside columns, which equals its
//     value at the clamped column (the same values in the same order).
//   * conv: kRun outputs a thread along the pass from a sliding register
//     window; phase ph runs the H pass of channel ph into scratch half
//     ph & 1 beside the W pass of channel ph - 1 from the other half, then
//     an epilogue (identity, unsharp, bloom add) that may read the stage's
//     x source.  Each output is one FMA chain in ascending tap order from
//     0.  stencil: sharpen, sobel (luma of each tap), emboss, median9;
//     term lists of up to 9 terms ride in registers for the stage.
//     point: channel-full ops of one or two inputs at a pixel (a 3x3 colour
//     matrix, or a fifth param, comes as tap list 0, expanded once a block
//     into a dense table); a synthesized GLSL conv or stencil's affine mix
//     s_c v_c + p_c x_c + b_c of the conv or stencil stage before it (v,
//     f32) and that stage's input (x), its twelve floats as tap list 0;
//     and a GLSL point shader's op list (glsl/lower.py PointProgram, the
//     int words of tap list 0), evaluated for several pixels a thread over
//     register files in shared memory (MC_GLSL, the kernel's glsl form
//     only; glsl_cells), of any number of inputs (the third and later
//     from the launch's table, GlslArgs::in); a list past the narrow op
//     word's fields, or whose files fit no tile, runs the wide form, one
//     pixel a thread, its files in device memory.  A list that gathers
//     (GATHER: a channel of the kernel input at a computed point, read
//     from device memory) runs a gather form of its own.
//   * Border mode, whole-plan.  "edge" (every builtin, and GLSL shaders
//     that clamp their reads) or "zero" (a synthesized GLSL conv or
//     stencil that reads out of bounds as zero, GL's robust access): the
//     input block and a conv's per-channel windows then read zeros
//     outside the image (the glsl form runs such plans).  The planner
//     takes zero mode only where no conv or stencil stage reads an
//     intermediate, so no pool slot needs a zero fill.
//   * Storage rounding.  Each node's output rounds to storage (bf16 RNE
//     or the rgba8 grid, pixel_ops.cuh store_round) as per-node
//     execution stores it; a bloom pre-map (store == 0) stays f32.
//
// The stage list arrives by value (a __grid_constant__ parameter), read a
// stage at a time into registers.  Point and stencil arithmetic rounds
// each operation (__fmul_rn/__fadd_rn) as the plain PyTorch version does;
// the conv tap loops use FMAs.  fminf/fmaxf drop a NaN where torch.minimum
// propagates it; images are finite (a GLSL op list propagates NaN as
// torch does).
//
// Bound on the card: issue slots.  The demo's conv (blur sigma 8, 49 taps
// a pass) issues 2.75 FMAs an output and tap at its 16x64 tile (the H pass
// covers the 48 halo columns).  At 3840x2160 on an H100 80GB HBM3 at
// 700 W the demo takes 0.900 ms (1.856 before this design; an A/B on the
// card): conv FMAs 0.28, the conv's window loads, phases and stores
// 0.33, sharpen 0.10, the input block 0.10 (parts cut out on the card;
// PERF.md §6).
//
// Grid: (ceil(W / TW), ceil(H / TH)).

#include "conv_tile.cuh"
#include "pixel_ops.cuh"

namespace rf {

constexpr int kMcMaxStages = 24;
constexpr int kMcStageInts = 22;
// MC_GLSL stages' inputs past the second, for the whole plan
// (cuda_ops.MC_GLSL_INPUTS; GlslArgs).
constexpr int kMcGlslInputs = 24;

enum McKind : int { MC_POINT = 0, MC_STENCIL = 1, MC_CONV = 2 };

enum McOp : int {
  MC_COPY = 0,         // in0
  MC_MIX = 1,          // in0 + (in1 - in0) * p0, all channels
  MC_ACES = 2,         // rgb: ACES filmic of in0 * p0
  MC_REINHARD = 3,     // rgb: Reinhard of in0 * p0
  MC_VIGNETTE = 4,     // rgb: in0 * radial fade (p0 strength, p1 radius, p2 1.42 - radius)
  MC_GRAYSCALE = 5,    // rgb: luma(in0)
  MC_SATURATION = 6,   // rgb: y + (in0 - y) * p0
  MC_THRESHOLD = 7,    // rgb: luma(in0) > p0
  MC_BLOOM_PRE = 8,    // rgb: in0 * smoothstep(p0, p0 + p1, luma)
  MC_CH0 = 9,          // MC_CH0 + k: rgb: channel op k (pixel_ops.cuh); levels' p4 in list 0
  MC_SEPIA = MC_CH0 + CH_COUNT,  // rgb: in0 + (clip01(sepia . in0) - in0) * p0
  MC_HUE_SAT = MC_SEPIA + 1,     // rgb: hue matrix (list 0, 3x3), saturation p0, lightness p1
  MC_AFFINE = MC_HUE_SAT + 1,    // all channels: s_c in0 + p_c in1 + b_c (list 0, rows c)
  MC_GLSL = MC_AFFINE + 1,       // all channels: a GLSL point shader's op list (list 0's ints)
  MC_CONV_IDENTITY = 32,
  MC_CONV_UNSHARP = 33,  // rgb: x + p0 * (x - blur)
  MC_CONV_BLOOM = 34,    // rgb: x + p0 * blur
  MC_SHARPEN = 48,     // rgb: x + p0 * wsum(list 0)
  MC_SOBEL = 49,       // rgb: sqrt(gx^2 + gy^2) * p0 over luma
  MC_EMBOSS = 50,      // rgb: wsum(list 0)
  MC_MEDIAN3 = 51,     // rgb: median9
};

// A stage's input: where it lies, and the extent it was computed over.
// off >= 0: a pool slot at that float offset of dynamic shared memory,
// layout (4, TH + 2eh, TW + 2ew rounded up to odd); kMcInputBlock: the
// input block (float 0; its layout is conv_tile.cuh's window of extent
// (in_eh, in_ew)); kMcGlobal: the kernel input in device memory (a conv's
// per-channel windows); -1: none (cuda_ops.McProgram.packed).
struct McBuf {
  int off, eh, ew;
};
constexpr int kMcNone = -1, kMcGlobal = -2, kMcInputBlock = -3;

__device__ __forceinline__ int pitch(int cols) { return cols | 1; }

// The kernel's lambdas are inlined by force: left to NVVM's heuristics, two
// of them (a conv's W pass, a point stage's cell) stayed calls in every
// form, their closures in a 776-byte stack frame, once the glsl form's
// op list was compiled beside them.
#define RF_INLINE __attribute__((always_inline))

// Outputs a thread computes along a conv pass: a full run takes
// conv_tile.cuh's run_conv, a run cut by the block's edge conv_run below.
constexpr int kRun = kConvRun;

// One stage; the int fields in the order of cuda_ops.McProgram.packed.
struct McStage {
  int kind, code, n_in;
  McBuf in0, in1, xs;
  int out_off;  // -1: the kernel output
  int eh, ew;   // output extent
  int rh, rw;   // conv radii, or the stencil radius twice
  int t0, n0, t1, n1;  // tap lists: offsets into the taps and their lengths
  int store;    // round to storage
  float p[4];
};

// Offsets in floats of dynamic shared memory (cuda_ops.McProgram._layout):
// the input block at 0 (in_used: some stage reads it), the pool, n_win
// buffers for a conv's per-channel windows (win_off, win_floats each), the
// H-pass scratch, the taps.
struct McArgs {
  int n_stages, scratch_off, taps_off, n_taps;
  int in_eh, in_ew, in_used, win_off, win_floats, n_win;
  McStage st[kMcMaxStages];
  int zero;  // border mode: zeros outside the image (else the clamped pixel's value)
  // The input is a slab of the image: its row 0 is image row row0, and the
  // image has height rows (0 and the input's rows for a whole frame).
  // Coordinates are the image's; clamped reads stop at the slab's edge.
  int row0, height;
  int glsl_pix;    // an op list's pixels a thread: 2 or 4 (the wide form: 1)
  // 1: an op list calls sinf, cosf or tanf; 2: it has loops, shifts, bit
  // casts or reads a third image; 4: the lists are in the wide op word,
  // their register files in device memory (GlslArgs::files); 8: a list
  // gathers from the kernel input.
  int glsl_flags;
};

// What only the glsl forms that have such ops read, a parameter of its own
// beside McArgs (whose layout the other forms keep).  in: the MC_GLSL
// stages' inputs past the second, for the whole plan (a stage's t1 is the
// first of its own, n1 their count), each the view at the stage's extent
// placed on the host (cuda_ops.McProgram.glsl_inputs): its float offset
// in dynamic shared memory, its pitch and its plane, the same for every
// block.  files: the wide form's register files, file_slots files of
// file_floats floats, one for each block the card holds at once, each
// taken by a block for its life through its word of file_locks.
struct GlslArgs {
  int in[3 * kMcGlslInputs];
  float* files;
  int* file_locks;
  int file_slots, file_floats;
};

struct McGeo {
  int H, W, TH, TW, y0, x0;  // H: the image's rows (coordinate math)
  int in_lo, in_wp;  // the input block's first column and pitch
};

// Channel c of a buffer's pixel (r, cc) of a block of extent (eh, ew), the
// block's pixel (0, 0) being image pixel (y0 - eh, x0 - ew):
// p[c * plane + r * pitch + cc].
struct View {
  const float* p;
  int pitch, plane;
};

__device__ __forceinline__ View view(const float* sm, const McBuf& b, const McGeo& g, int eh,
                                     int ew) {
  const bool in = b.off == kMcInputBlock;
  const int pt = in ? g.in_wp : pitch(g.TW + 2 * b.ew);
  const float* base = sm + (in ? g.in_lo : b.off);
  return View{base + (b.eh - eh) * pt + (b.ew - ew), pt, (g.TH + 2 * b.eh) * pt};
}

// Dense tables of the point stages' list 0, a block's copy: the 3x3 colour
// matrix at dy * 3 + dx, the affine mix's (s, p, b) of channel c at 3c ..
// 3c + 2.
constexpr int kDense = 12;

// rows of m (row-major 3x3) applied to a[0..2], each r m0 + g m1 + b m2.
__device__ __forceinline__ void matrix_rgb(const float* m, const float* a, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = __fadd_rn(__fadd_rn(__fmul_rn(a[0], m[3 * i]), __fmul_rn(a[1], m[3 * i + 1])),
                       __fmul_rn(a[2], m[3 * i + 2]));
}

// The point ops of the channel-local and colour-matrix builtins (opcodes
// from MC_CH0): colour channels of the output from in0 (a) and in1 (b); q4:
// levels' fifth param; m: the stage's dense table.
__device__ __forceinline__ void point_op_colour(int code, const float* p, float q4,
                                                const float* m, const float* a, const float* b,
                                                int gy, int gx, float* o) {
  if (code < MC_CH0 + CH_COUNT) {
    const float q[5] = {p[0], p[1], p[2], p[3], q4};
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = channel_op(code - MC_CH0, c, a[c], b[c], q, gy, gx);
  } else if (code == MC_SEPIA) {
    // cuda_ops.SEPIA_MATRIX
    const float s[9] = {0.393f, 0.769f, 0.189f, 0.349f, 0.686f, 0.168f, 0.272f, 0.534f, 0.131f};
    float t[3];
    matrix_rgb(s, a, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = __fadd_rn(a[c], __fmul_rn(__fsub_rn(clip01(t[c]), a[c]), p[0]));
  } else if (code == MC_HUE_SAT) {
    float t[3];
    matrix_rgb(m, a, t);
    const float y = luma(t[0], t[1], t[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = __fadd_rn(__fadd_rn(y, __fmul_rn(__fsub_rn(t[c], y), p[0])), p[1]);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = __int_as_float(0x7fc00000);  // unknown opcode: NaN
  }
}

// A synthesized GLSL stage's mix, channel by channel: s v, plus p x where
// p != 0, plus b where b != 0 (cuda_ops.affine_mix_plain); (s, p, b) of
// channel c are m[3c..3c+2].  Compiled only into the kernel's kAffine form:
// built into the builtins' form as well it cost the demo's mc kernel 3% on
// the card at the same register count (PERF.md).
__device__ __forceinline__ void point_op_affine(const float* m, const float* v, const float* x,
                                                float* o) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = __fmul_rn(v[c], m[3 * c]);
    if (m[3 * c + 1] != 0.f) o[c] = __fadd_rn(o[c], __fmul_rn(x[c], m[3 * c + 1]));
    if (m[3 * c + 2] != 0.f) o[c] = __fadd_rn(o[c], m[3 * c + 2]);
  }
}

template <bool kAffine>
__device__ __forceinline__ void point_op(const McStage& st, const float* a, const float* b,
                                         const float* m, float q4, const McGeo& g, int gy, int gx,
                                         float* o) {
  const float* p = st.p;
  o[3] = a[3];
  if (st.code >= MC_CH0) {
    if constexpr (kAffine) {
      if (st.code == MC_AFFINE) {
        point_op_affine(m, a, b, o);
        return;
      }
    }
    point_op_colour(st.code, p, q4, m, a, b, gy, gx, o);
    return;
  }
  switch (st.code) {
    case MC_COPY:
      for (int c = 0; c < 3; ++c) o[c] = a[c];
      return;
    case MC_MIX:
      for (int c = 0; c < 4; ++c) o[c] = __fadd_rn(a[c], __fmul_rn(__fsub_rn(b[c], a[c]), p[0]));
      return;
    case MC_ACES:
      for (int c = 0; c < 3; ++c) {
        const float v = __fmul_rn(a[c], p[0]);
        const float num = __fmul_rn(v, __fadd_rn(__fmul_rn(2.51f, v), 0.03f));
        const float den = __fadd_rn(__fmul_rn(v, __fadd_rn(__fmul_rn(2.43f, v), 0.59f)), 0.14f);
        o[c] = clip01(__fdiv_rn(num, den));
      }
      return;
    case MC_REINHARD:
      for (int c = 0; c < 3; ++c) {
        const float v = __fmul_rn(a[c], p[0]);
        o[c] = __fdiv_rn(v, __fadd_rn(1.f, v));
      }
      return;
    case MC_VIGNETTE: {
      const float ny = __fsub_rn(__fmul_rn(__fdiv_rn((float)gy, (float)max(g.H - 1, 1)), 2.f), 1.f);
      const float nx = __fsub_rn(__fmul_rn(__fdiv_rn((float)gx, (float)max(g.W - 1, 1)), 2.f), 1.f);
      const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)));
      const float fade = __fsub_rn(1.f, __fmul_rn(p[0], smoothstep(p[1], p[2], d)));
      for (int c = 0; c < 3; ++c) o[c] = __fmul_rn(a[c], fade);
      return;
    }
    case MC_GRAYSCALE: {
      const float y = luma(a[0], a[1], a[2]);
      for (int c = 0; c < 3; ++c) o[c] = y;
      return;
    }
    case MC_SATURATION: {
      const float y = luma(a[0], a[1], a[2]);
      for (int c = 0; c < 3; ++c) o[c] = __fadd_rn(y, __fmul_rn(__fsub_rn(a[c], y), p[0]));
      return;
    }
    case MC_THRESHOLD: {
      const float m1 = luma(a[0], a[1], a[2]) > p[0] ? 1.f : 0.f;
      for (int c = 0; c < 3; ++c) o[c] = m1;
      return;
    }
    case MC_BLOOM_PRE: {
      const float m1 = smoothstep(p[0], p[1], luma(a[0], a[1], a[2]));
      for (int c = 0; c < 3; ++c) o[c] = __fmul_rn(a[c], m1);
      return;
    }
  }
  for (int c = 0; c < 4; ++c) o[c] = __int_as_float(0x7fc00000);  // unknown opcode: NaN
}


// ---- GLSL point shaders: glsl/lower.py PointProgram --------------------------
//
// A point shader's op list, packed by PointProgram.packed: each typed op of
// the list resolved on the host to one of these opcodes (glsl/lower.py
// KERNEL_OPS, in this order), so the kernel dispatches once an op.  Two
// register files, floats and integers (i32, i64 -- the interpreter's
// uint, int64 masked to 32 bits -- and bool as 0 or 1, all in 64 bits,
// i32 sign-extended), each sized to the program's live registers.
enum GlslKop : int {
  K_LOAD = 0, K_COORD_X, K_COORD_Y, K_TIME, K_FADD, K_FSUB, K_FMUL, K_FDIV, K_FREM, K_FFMOD,
  K_FMAX, K_FMIN, K_FPOW, K_FATAN2, K_FEQ, K_FNE, K_FLT, K_FLE, K_FGT, K_FGE, K_FNEG, K_FABS,
  K_FSIGN, K_FFLOOR, K_FCEIL, K_FTRUNC, K_FROUND, K_FEXP, K_FEXP2, K_FLOG, K_FLOG2, K_FSQRT,
  K_FRECIP, K_FSIN, K_FCOS, K_FTAN, K_FASIN, K_FACOS, K_FATAN, K_FSINH, K_FCOSH, K_FTANH,
  K_FISNAN, K_FWHERE, K_FCLAMP, K_FNAN2NUM, K_IADD, K_ISUB, K_IMUL, K_IDIV, K_IFLOORDIV, K_IREM,
  K_IFMOD, K_IMAX, K_IMIN, K_IAND, K_IOR, K_IXOR, K_IEQ, K_INE, K_ILT, K_ILE, K_IGT, K_IGE,
  K_INEG, K_IABS, K_ISIGN, K_INOT, K_ILNOT, K_IWHERE, K_ICLAMP, K_F2I, K_F2L, K_F2B, K_I2F, K_L2F,
  K_B2F, K_L2I, K_I2B, K_ICOPY, K_FMOV, K_IMOV, K_ISHL, K_ISHR, K_LOOP, K_LOADX, K_FBITS, K_IBITS,
  K_GATHER,
};
// The packed program's header ints (glsl/lower.py HEAD_INTS: ops, the
// files' live registers, the float and integer constants, the four output
// channels' operands, flags) and the bit of an operand field that names a
// constant (CONST).  P below: the pixels a thread evaluates together, 2
// or 4, the plan's choice (cuda_ops.MC_GLSL_PIXELS, McProgram.tile); a
// register's plane holds one value a lane, P lanes a thread.
constexpr int kGlslHead = 10, kGlslConst = 0x80;
// The wide op word's constant bit (glsl/lower.py WIDE_CONST): four words
// an op, 16-bit fields.
constexpr int kGlslWideConst = 0x8000;

// What a GATHER reads: the kernel input in device memory (the planner lets
// a stage gather only the plan's input, complete before the launch), H rows
// of W pixels a channel.  A gathered point may lie hundreds of pixels from
// the block (crt.frag's barrel warp moves a corner by ~460 at 4K), so it
// is read through the read-only cache, not from the shared-memory tile.
template <typename T>
struct GlslGatherSrc {
  const T* x;
  int H, W;
};

// Design (H100).  An op list indexes its registers at run time, and
// register arrays need constant indices, so the files live in shared
// memory, register-major with the lanes consecutive (plane r, lane p *
// kThreads + thread): a warp's access to one register of one pixel is 32
// consecutive words, conflict-free.  The region overlays the conv windows
// and H-pass scratch, which no point stage touches (cuda_ops.McProgram
// ._layout), so a plan with a conv pays for the files only past that
// span.  Constants stay in the program's own table in the block's idx
// copy, read as a broadcast (never copied into a file).  Each thread runs
// the list for P cells of the block at once: an op is read (one
// 8-byte load; the lists start on even words) and dispatched once for
// P independent chains, whose shared-memory latencies overlap.

// An operand for the P pixels: a register's plane at this thread's
// first lane (step kThreads to the next pixel's), or a constant (step 0).
template <typename V>
struct GlslSrc {
  const V* p;
  int step;
  __device__ __forceinline__ V operator[](int k) const { return p[k * step]; }
};

// The wide form (kWide: lists past the narrow word's 128 registers or
// constants of a class, or whose files fit no tile at two pixels a thread)
// runs one pixel a thread, its constants' field bit the wide one; its
// files lie in device memory, reached through L1 and L2.
template <int P, bool kWide = false>
struct GlslFiles {
  static constexpr int kLanes = kThreads * P;
  static constexpr int kGlslConst = kWide ? kGlslWideConst : rf::kGlslConst;
  float* f;             // float register 0 at this thread's first lane
  long long* i;         // integer register 0 there
  const float* cf;      // the float constants
  const long long* ci;  // the integer constants
  __device__ __forceinline__ GlslSrc<float> fs(int a) const {
    return a & kGlslConst ? GlslSrc<float>{cf + (a & (kGlslConst - 1)), 0}
                          : GlslSrc<float>{f + a * kLanes, kThreads};
  }
  __device__ __forceinline__ GlslSrc<long long> is(int a) const {
    return a & kGlslConst ? GlslSrc<long long>{ci + (a & (kGlslConst - 1)), 0}
                          : GlslSrc<long long>{i + a * kLanes, kThreads};
  }
};

// dst[pixel k] = fn(k) for the P pixels: every pixel's operands
// read before any result is stored (a store may alias a later read, so
// the compiler keeps the order written: loads, ops, stores), so that the
// chains' shared-memory latencies overlap.
template <int P, typename V, typename Fn>
__device__ __forceinline__ void glsl_each(V* dst, Fn fn) {
  V v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = fn(k);
#pragma unroll
  for (int k = 0; k < P; ++k) dst[k * kThreads] = v[k];
}

// The same, one pixel after another in a loop kept rolled: for the ops
// whose code is long (transcendentals, remainders, 64-bit division), so
// that the list's code stays small; their own latency covers the chain.
template <int P, typename V, typename Fn>
__device__ __forceinline__ void glsl_each_rolled(V* dst, Fn fn) {
#pragma unroll 1
  for (int k = 0; k < P; ++k) dst[k * kThreads] = fn(k);
}

// dst = fn(a, b) of two float operands, for the P pixels.
template <int P, typename Files, typename Fn>
__device__ __forceinline__ void glsl_ff(const Files& R, float* dst, int x, int y, Fn fn) {
  const GlslSrc<float> X = R.fs(x), Y = R.fs(y);
  glsl_each<P>(dst, [&](int k) RF_INLINE { return fn(X[k], Y[k]); });
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ long long wrap32(bool w, long long v) {
  return w ? (long long)(int)v : v;
}

// The op list for P pixels: in0/in1 the stage's input views, at0 /
// at1 each pixel's offset in them, (gy, gx) its image pixel, (cr, cc) its
// place in the block, where LOADX reads an input past the second through
// its view in more (offset from sm, pitch, plane); gsrc what a GATHER
// reads (kGather: the gather forms only).  An op is two words
// with 8-bit fields, or in the wide form four with 16-bit ones
// (glsl/lower.py PointProgram.packed).  A loop
// region ends in a LOOP op that jumps back to the region's first op (the
// next op's words then load from there), so a warp's threads run a loop
// as many rounds as the slowest of their pixels; no __syncthreads() in
// here (a block's warps leave a loop at different rounds).  Float ops
// round once each, with the CUDA math functions that torch's CUDA kernels
// call for the interpreter's ops (expf for torch.exp, sinf for torch.sin,
// ...), a correctly rounded square root and reciprocal, round half to
// even; maximum and minimum propagate NaN (torch's rule); remainder takes
// the divisor's sign, fmod the dividend's.  Integer ops wrap in their
// width (the op's wrap flag: i32); division truncates (IDIV) or floors
// (IFLOORDIV).  Casts convert as torch does: float to integer truncates
// toward zero, i64 to i32 wraps, anything nonzero (NaN too) is true.
// The plain float arithmetic (FMUL, FADD, FSUB) is tested first, a
// compare each: the compiler lowers the switch of the other ops to a
// search tree some seven branches deep.  (Keeping the last op's results
// in registers for the next op, forwarded past shared memory, ran
// glsl-chain 12% slower on the card.)
template <int P, bool kTrig, bool kExt, bool kWide, bool kGather, typename T>
__device__ __forceinline__ void glsl_ops(const int* __restrict__ prog,
                                         const GlslFiles<P, kWide>& R, const View& in0,
                                         const View& in1, const int (&at0)[P],
                                         const int (&at1)[P], const int (&gy)[P],
                                         const int (&gx)[P], float time, const float* sm,
                                         const int* more, const int (&cr)[P],
                                         const int (&cc)[P], const GlslGatherSrc<T>& gsrc) {
  using Word = std::conditional_t<kWide, int4, int2>;
  const int n_ops = prog[0], k_f = prog[3];
  int at = kGlslHead + k_f + (k_f & 1) + 2 * prog[4];
  if constexpr (kWide) at = (at + 3) & ~3;  // a wide list's ops: 16-byte reads
  const Word* ops = reinterpret_cast<const Word*>(prog + at);
  Word next = n_ops > 0 ? ops[0] : Word{};
  for (int n = 0; n < n_ops; ++n) {
    // The next op's words load before this op's stores (which the compiler
    // may not move them past: both lie in shared memory).
    int op, d, x, y, z, u, target;
    bool wr;
    if constexpr (kWide) {
      const unsigned w0 = next.x, w1 = next.y, w2 = next.z, w3 = next.w;
      if (n + 1 < n_ops) next = ops[n + 1];
      op = w0 & 255, wr = (w0 >> 8) & 1, d = w0 >> 16, x = w1 & 0xffff, y = w1 >> 16;
      z = w2 & 0xffff, u = w2 >> 16, target = w3 & 0xffff;
    } else {
      const unsigned w0 = next.x, w1 = next.y;
      if (n + 1 < n_ops) next = ops[n + 1];
      op = w0 & 255, d = (w0 >> 8) & 255, x = (w0 >> 16) & 255, y = w0 >> 24;
      z = w1 & 255, u = (w1 >> 8) & 255, wr = (w1 >> 16) & 1, target = w1 & 0xffff;
    }
    float* const F = R.f + d * R.kLanes;
    long long* const I = R.i + d * R.kLanes;
    if (op == K_FMUL) {
      glsl_ff<P>(R, F, x, y, [](float a, float b) RF_INLINE { return __fmul_rn(a, b); });
      continue;
    }
    if (op == K_FADD) {
      glsl_ff<P>(R, F, x, y, [](float a, float b) RF_INLINE { return __fadd_rn(a, b); });
      continue;
    }
    if (op == K_FSUB) {
      glsl_ff<P>(R, F, x, y, [](float a, float b) RF_INLINE { return __fsub_rn(a, b); });
      continue;
    }
    if constexpr (kGather) {
      // Channel y of the kernel input at row z, column u (integer
      // registers), converted from storage as the tile's load converts it.
      // The list's own clamps (texture()'s, imageLoad's) keep the point in
      // the image; the bounds here only keep a list without them from
      // reading past the input.  Only the gather forms (header flag 8).
      if (op == K_GATHER) {
        const GlslSrc<long long> Y = R.is(z), X = R.is(u);
        const T* src = gsrc.x + (size_t)y * gsrc.H * gsrc.W;
        glsl_each<P>(F, [&](int k) RF_INLINE {
          const long long r = Y[k] < 0 ? 0 : Y[k] >= gsrc.H ? gsrc.H - 1 : Y[k];
          const long long c = X[k] < 0 ? 0 : X[k] >= gsrc.W ? gsrc.W - 1 : X[k];
          return to_f32(__ldg(src + (size_t)r * gsrc.W + (size_t)c));
        });
        continue;
      }
    }
    if constexpr (kExt) {
      // The ops of loops, shifts, inputs past the second and bit casts, only
      // in the forms for lists that have them (the header's flags): the
      // other forms' switch stays as it was without them.
      if (op >= K_FMOV) {
        const GlslSrc<long long> X = R.is(x), Y = R.is(y);
        switch (op) {
          case K_FMOV: {
            const GlslSrc<float> A = R.fs(x);
            glsl_each<P>(F, [&](int k) RF_INLINE { return A[k]; });
            break;
          }
          case K_IMOV: glsl_each<P>(I, [&](int k) RF_INLINE { return X[k]; }); break;
          // Shifts as torch does them: << on the unsigned type (a wrap is
          // defined), a count outside [0, width) gives 0; >> arithmetic, a
          // count outside [0, width - 1) gives the sign.
          case K_ISHL:
            glsl_each<P>(I, [&](int k) RF_INLINE {
              const long long a = X[k], b = Y[k];
              return b < 0 || b >= (wr ? 32 : 64)
                         ? 0ll
                         : wrap32(wr, (long long)((unsigned long long)a << b));
            });
            break;
          case K_ISHR:
            glsl_each<P>(I, [&](int k) RF_INLINE {
              const long long a = X[k], b = Y[k], top = wr ? 31 : 63;
              return a >> (b < 0 || b > top ? top : b);
            });
            break;
          case K_LOOP: {
            // A loop's back-edge (after the moves of the body's results
            // into the carried registers): the round counter d counts this
            // round; the warp's threads, P pixels each, go back together to
            // the body's first op while any of their pixels is active (x)
            // and the count is below the cap (y), as the interpreter's
            // rounds do for the whole image (a pixel past its exit runs the
            // body masked, which changes nothing).  Together, so that the
            // warp's threads stay at one op: a thread that left the loop
            // alone would run the rest of the list beside the others, every
            // op dispatched once a group.  The counter is the same for the P
            // pixels: pixel 0's.
            const long long rounds = I[0] + 1;
            bool any = false;
#pragma unroll
            for (int k = 0; k < P; ++k) any |= X[k] != 0;
            I[0] = rounds;
            any = __any_sync(__activemask(), any);
            if (any && rounds < Y[0]) {
              n = target - 1;
              next = ops[n + 1];
            }
            break;
          }
          case K_LOADX: {  // channel y of input x >= 2, at the pixel's place in the block
            const int* v = more + 3 * (x - 2);
            const float* src = sm + v[0] + y * v[2];
            const int pitch = v[1];
            glsl_each<P>(F, [&](int k) RF_INLINE { return src[cr[k] * pitch + cc[k]]; });
            break;
          }
          // Bit casts move the bits and nothing else (a NaN's payload, -0,
          // a denormal): f32 as the i32 of the register's low word, and back.
          case K_FBITS: {
            const GlslSrc<float> A = R.fs(x);
            glsl_each<P>(I, [&](int k) RF_INLINE { return (long long)__float_as_int(A[k]); });
            break;
          }
          case K_IBITS: glsl_each<P>(F, [&](int k) RF_INLINE { return __int_as_float((int)X[k]); }); break;
        }
        continue;
      }
    }
    switch (op) {
      case K_LOAD: {  // channel y of input x, straight from its view
        const bool first = x == 0;
        const float* src = first ? in0.p + y * in0.plane : in1.p + y * in1.plane;
        glsl_each<P>(F, [&](int k) RF_INLINE { return src[first ? at0[k] : at1[k]]; });
        break;
      }
      case K_COORD_X: glsl_each<P>(I, [&](int k) RF_INLINE { return (long long)gx[k]; }); break;
      case K_COORD_Y: glsl_each<P>(I, [&](int k) RF_INLINE { return (long long)gy[k]; }); break;
      case K_TIME: glsl_each<P>(F, [&](int) RF_INLINE { return time; }); break;
#define GLSL_F2(each, dst, expr)                                 \
  {                                                              \
    const GlslSrc<float> X = R.fs(x), Y = R.fs(y);               \
    each(dst, [&](int k) RF_INLINE { const float a = X[k], b = Y[k]; return (expr); }); \
  }                                                              \
  break
#define GLSL_F1(each, dst, expr)                                 \
  {                                                              \
    const GlslSrc<float> X = R.fs(x);                            \
    each(dst, [&](int k) RF_INLINE { const float a = X[k]; return (expr); }); \
  }                                                              \
  break
#define GLSL_I2(each, expr)                                      \
  {                                                              \
    const GlslSrc<long long> X = R.is(x), Y = R.is(y);           \
    each(I, [&](int k) RF_INLINE {                               \
      const long long a = X[k], b = Y[k];                        \
      return (long long)(expr);                                  \
    });                                                          \
  }                                                              \
  break
#define GLSL_I1(dst, expr)                                       \
  {                                                              \
    const GlslSrc<long long> X = R.is(x);                        \
    glsl_each<P>(dst, [&](int k) RF_INLINE { const long long a = X[k]; return (expr); }); \
  }                                                              \
  break
      case K_FDIV: GLSL_F2(glsl_each<P>, F, __fdiv_rn(a, b));
      case K_FREM: GLSL_F2(glsl_each_rolled<P>, F, [&] {
        float m = fmodf(a, b);
        if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = __fadd_rn(m, b);
        return m;
      }());
      case K_FFMOD: GLSL_F2(glsl_each_rolled<P>, F, fmodf(a, b));
      case K_FMAX: GLSL_F2(glsl_each<P>, F, a != a || b != b ? nan_f() : fmaxf(a, b));
      case K_FMIN: GLSL_F2(glsl_each<P>, F, a != a || b != b ? nan_f() : fminf(a, b));
      case K_FPOW: GLSL_F2(glsl_each_rolled<P>, F, powf(a, b));
      case K_FATAN2: GLSL_F2(glsl_each_rolled<P>, F, atan2f(a, b));
      case K_FEQ: GLSL_F2(glsl_each<P>, I, (long long)(a == b));
      case K_FNE: GLSL_F2(glsl_each<P>, I, (long long)(a != b));
      case K_FLT: GLSL_F2(glsl_each<P>, I, (long long)(a < b));
      case K_FLE: GLSL_F2(glsl_each<P>, I, (long long)(a <= b));
      case K_FGT: GLSL_F2(glsl_each<P>, I, (long long)(a > b));
      case K_FGE: GLSL_F2(glsl_each<P>, I, (long long)(a >= b));
      case K_FNEG: GLSL_F1(glsl_each<P>, F, -a);
      case K_FABS: GLSL_F1(glsl_each<P>, F, fabsf(a));
      case K_FSIGN: GLSL_F1(glsl_each<P>, F, (float)((0.f < a) - (a < 0.f)));
      case K_FFLOOR: GLSL_F1(glsl_each<P>, F, floorf(a));
      case K_FCEIL: GLSL_F1(glsl_each<P>, F, ceilf(a));
      case K_FTRUNC: GLSL_F1(glsl_each<P>, F, truncf(a));
      case K_FROUND: GLSL_F1(glsl_each<P>, F, rintf(a));
      case K_FEXP: GLSL_F1(glsl_each_rolled<P>, F, expf(a));
      case K_FEXP2: GLSL_F1(glsl_each_rolled<P>, F, exp2f(a));
      case K_FLOG: GLSL_F1(glsl_each_rolled<P>, F, logf(a));
      case K_FLOG2: GLSL_F1(glsl_each_rolled<P>, F, log2f(a));
      case K_FSQRT: GLSL_F1(glsl_each<P>, F, __fsqrt_rn(a));
      case K_FRECIP: GLSL_F1(glsl_each<P>, F, __fdiv_rn(1.f, a));
// Only the trig forms (a list whose header flags sinf, cosf or tanf) carry
// the three: their argument reduction for |x| > 105615 indexes seven words
// at run time, a 32-byte stack frame the other forms do without.
#define GLSL_TRIG(fn)                                            \
  if constexpr (kTrig) {                                         \
    const GlslSrc<float> X = R.fs(x);                            \
    glsl_each_rolled<P>(F, [&](int k) RF_INLINE { return fn(X[k]); }); \
  } else {                                                       \
    glsl_each<P>(F, [&](int) RF_INLINE { return nan_f(); });     \
  }                                                              \
  break
      case K_FSIN: GLSL_TRIG(sinf);
      case K_FCOS: GLSL_TRIG(cosf);
      case K_FTAN: GLSL_TRIG(tanf);
      case K_FASIN: GLSL_F1(glsl_each_rolled<P>, F, asinf(a));
      case K_FACOS: GLSL_F1(glsl_each_rolled<P>, F, acosf(a));
      case K_FATAN: GLSL_F1(glsl_each_rolled<P>, F, atanf(a));
      case K_FSINH: GLSL_F1(glsl_each_rolled<P>, F, sinhf(a));
      case K_FCOSH: GLSL_F1(glsl_each_rolled<P>, F, coshf(a));
      case K_FTANH: GLSL_F1(glsl_each_rolled<P>, F, tanhf(a));
      case K_FISNAN: GLSL_F1(glsl_each<P>, I, (long long)(a != a));
      case K_FWHERE: {
        const GlslSrc<long long> C = R.is(x);
        const GlslSrc<float> A = R.fs(y), B = R.fs(z);
        glsl_each<P>(F, [&](int k) RF_INLINE { return C[k] ? A[k] : B[k]; });
        break;
      }
      case K_FCLAMP: {
        const GlslSrc<float> A = R.fs(x), L = R.fs(y), U = R.fs(z);
        glsl_each<P>(F, [&](int k) RF_INLINE {
          const float a = A[k];
          return a != a ? a : fminf(fmaxf(a, L[k]), U[k]);
        });
        break;
      }
      case K_FNAN2NUM: {
        const GlslSrc<float> A = R.fs(x), N = R.fs(y), Pos = R.fs(z), Neg = R.fs(u);
        glsl_each<P>(F, [&](int k) RF_INLINE {
          const float a = A[k];
          return a != a ? N[k] : isinf(a) ? (a > 0.f ? Pos[k] : Neg[k]) : a;
        });
        break;
      }
      case K_IADD:
        GLSL_I2(glsl_each<P>, wrap32(wr, (long long)((unsigned long long)a + (unsigned long long)b)));
      case K_ISUB:
        GLSL_I2(glsl_each<P>, wrap32(wr, (long long)((unsigned long long)a - (unsigned long long)b)));
      case K_IMUL:
        GLSL_I2(glsl_each<P>, wrap32(wr, (long long)((unsigned long long)a * (unsigned long long)b)));
      case K_IDIV:
        GLSL_I2(glsl_each_rolled<P>,
                b == 0 ? 0 : b == -1 ? wrap32(wr, (long long)(0ull - (unsigned long long)a)) : a / b);
      case K_IFLOORDIV: GLSL_I2(glsl_each_rolled<P>, [&] {
        long long v = 0;
        if (b == -1) {
          v = wrap32(wr, (long long)(0ull - (unsigned long long)a));
        } else if (b != 0) {
          v = a / b;
          if (a % b != 0 && ((a < 0) != (b < 0))) --v;
        }
        return v;
      }());
      case K_IREM: GLSL_I2(glsl_each_rolled<P>, [&] {
        long long v = b == 0 || b == -1 ? 0 : a % b;
        if (v != 0 && ((v < 0) != (b < 0))) v += b;
        return v;
      }());
      case K_IFMOD: GLSL_I2(glsl_each_rolled<P>, b == 0 || b == -1 ? 0 : a % b);
      case K_IMAX: GLSL_I2(glsl_each<P>, a > b ? a : b);
      case K_IMIN: GLSL_I2(glsl_each<P>, a < b ? a : b);
      case K_IAND: GLSL_I2(glsl_each<P>, a & b);
      case K_IOR: GLSL_I2(glsl_each<P>, a | b);
      case K_IXOR: GLSL_I2(glsl_each<P>, a ^ b);
      case K_IEQ: GLSL_I2(glsl_each<P>, a == b);
      case K_INE: GLSL_I2(glsl_each<P>, a != b);
      case K_ILT: GLSL_I2(glsl_each<P>, a < b);
      case K_ILE: GLSL_I2(glsl_each<P>, a <= b);
      case K_IGT: GLSL_I2(glsl_each<P>, a > b);
      case K_IGE: GLSL_I2(glsl_each<P>, a >= b);
      case K_INEG: GLSL_I1(I, wrap32(wr, (long long)(0ull - (unsigned long long)a)));
      case K_IABS:
        GLSL_I1(I, wrap32(wr, a < 0 ? (long long)(0ull - (unsigned long long)a) : a));
      case K_ISIGN: GLSL_I1(I, (long long)((a > 0) - (a < 0)));
      case K_INOT: GLSL_I1(I, wrap32(wr, ~a));
      case K_ILNOT: GLSL_I1(I, (long long)(a == 0));
      case K_IWHERE: {
        const GlslSrc<long long> C = R.is(x), A = R.is(y), B = R.is(z);
        glsl_each<P>(I, [&](int k) RF_INLINE { return C[k] ? A[k] : B[k]; });
        break;
      }
      case K_ICLAMP: {
        const GlslSrc<long long> A = R.is(x), L = R.is(y), U = R.is(z);
        glsl_each<P>(I, [&](int k) RF_INLINE {
          const long long v = A[k] < L[k] ? L[k] : A[k];
          return v > U[k] ? U[k] : v;
        });
        break;
      }
      case K_F2I: GLSL_F1(glsl_each<P>, I, (long long)__float2int_rz(a));
      case K_F2L: GLSL_F1(glsl_each<P>, I, __float2ll_rz(a));
      case K_F2B: GLSL_F1(glsl_each<P>, I, (long long)(a != 0.f));
      case K_I2F: GLSL_I1(F, __int2float_rn((int)a));
      case K_L2F: GLSL_I1(F, __ll2float_rn(a));
      case K_B2F: GLSL_I1(F, a ? 1.f : 0.f);
      case K_L2I: GLSL_I1(I, (long long)(int)a);
      case K_I2B: GLSL_I1(I, (long long)(a != 0));
      case K_ICOPY: GLSL_I1(I, a);
#undef GLSL_F2
#undef GLSL_F1
#undef GLSL_I2
#undef GLSL_I1
#undef GLSL_TRIG
      default: glsl_each<P>(F, [&](int) RF_INLINE { return nan_f(); });  // an opcode this kernel lacks
    }
  }
}

// An MC_GLSL stage over a rows x cols block whose pixel (0, 0) is image
// pixel (by, bx) of the slab (its row 0 the image's row0): for_each_cell's
// cells, P of them a thread at once (items threadIdx.x + (k + j P)
// blockDim.x).  A cell past the block or outside the image runs
// the list on the view's first pixel and stores nothing.  prog: the packed
// program in the block's idx copy (an even word; the wide form's ops on a
// 16-byte word); files: the register files' region (8-byte aligned, in
// shared memory; the wide form's in device memory); gsrc: what a GATHER
// reads.
template <int P, bool kTrig, bool kExt, bool kWide, bool kGather, typename T, typename Put>
__device__ __forceinline__ void glsl_cells(const int* __restrict__ prog, float* files,
                                           const View& in0, const View& in1, int rows, int cols,
                                           int by, int bx, int H, int W, int row0, float time,
                                           const float* sm, const int* more,
                                           const GlslGatherSrc<T>& gsrc, Put put) {
  const int n = rows * cols, k_f = prog[3];
  GlslFiles<P, kWide> R;
  R.i = reinterpret_cast<long long*>(files) + threadIdx.x;
  R.f = files + 2 * prog[2] * R.kLanes + threadIdx.x;
  R.cf = reinterpret_cast<const float*>(prog + kGlslHead);
  R.ci = reinterpret_cast<const long long*>(prog + kGlslHead + k_f + (k_f & 1));
  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int i = threadIdx.x; i < n; i += P * blockDim.x) {
    int cr[P], cc[P], at0[P], at1[P], gy[P], gx[P];
    bool ok[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const bool in_block = i + k * (int)blockDim.x < n;
      cr[k] = r;
      cc[k] = c;
      gy[k] = by + r;
      gx[k] = bx + c;
      ok[k] = in_block && gy[k] >= 0 && gy[k] < H && gx[k] >= 0 && gx[k] < W;
      if constexpr (kExt) {  // LOADX's place in the block: the first pixel's past it
        cr[k] = in_block ? r : 0;
        cc[k] = in_block ? c : 0;
      }
      at0[k] = in_block ? r * in0.pitch + c : 0;
      at1[k] = in_block ? r * in1.pitch + c : 0;
      gy[k] += row0;  // the image row
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
    glsl_ops<P, kTrig, kExt, kWide, kGather>(prog, R, in0, in1, at0, at1, gy, gx, time, sm,
                                             more, cr, cc, gsrc);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const GlslSrc<float> S = R.fs(prog[5 + ch]);
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (ok[k]) put(ch, cr[k], cc[k], S[k]);
    }
  }
}

__device__ __forceinline__ float conv_epilogue(int code, int c, float blur, float x, const float* p) {
  switch (code) {
    case MC_CONV_IDENTITY: return blur;
    case MC_CONV_UNSHARP: return c < 3 ? __fadd_rn(x, __fmul_rn(p[0], __fsub_rn(x, blur))) : x;
    case MC_CONV_BLOOM: return c < 3 ? __fadd_rn(x, __fmul_rn(p[0], blur)) : x;
  }
  return __int_as_float(0x7fc00000);
}

// A term list of at most kTerms9 terms (a 3x3 table), read once a stage
// into registers: each term's offset in a view of pitch `pitch` and its
// weight.
constexpr int kTerms9 = 9;
struct Terms9 {
  int off[kTerms9];
  float w[kTerms9];
  int n;
};

__device__ __forceinline__ Terms9 terms9(const float* taps, const int* idx, int t, int n,
                                         int pitch) {
  Terms9 r;
  r.n = n;
#pragma unroll
  for (int k = 0; k < kTerms9; ++k) {
    const int pos = k < n ? idx[t + k] : 0;
    r.off[k] = (pos >> 6) * pitch + (pos & 63);
    r.w[k] = k < n ? taps[t + k] : 0.f;
  }
  return r;
}

// wsum_ordered's serial chain (pixel_ops.cuh; n <= 16) over such a list:
// at(off) reads the view at a term's offset, `centre` is the centre's.
template <typename At>
__device__ __forceinline__ float wsum9(At at, const Terms9& t, int centre) {
  if (t.n == 0) return __fmul_rn(at(centre), 0.f);
  float acc = __fmul_rn(at(t.off[0]), t.w[0]);
#pragma unroll
  for (int k = 1; k < kTerms9; ++k)
    if (k < t.n) acc = __fadd_rn(acc, __fmul_rn(at(t.off[k]), t.w[k]));
  return acc;
}

// stencil_op's sharpen, emboss and sobel where each term list has at most
// kTerms9 terms, the lists in registers: the same products and sums in
// the same order.
__device__ __forceinline__ void stencil_op9(const McStage& st, const View& v, const Terms9& t0,
                                            const Terms9& t1, int r, int cc, float* o) {
  const float* at0 = v.p + r * v.pitch + cc;
  const int ctr = st.rh * v.pitch + st.rh;
  o[3] = at0[3 * v.plane + ctr];
  if (st.code == MC_SOBEL) {
    auto y = [&](int off) { return luma(at0[off], at0[v.plane + off], at0[2 * v.plane + off]); };
    const float gxs = wsum9(y, t0, ctr), gys = wsum9(y, t1, ctr);
    const float mag =
        __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(gxs, gxs), __fmul_rn(gys, gys))), st.p[0]);
    for (int c = 0; c < 3; ++c) o[c] = mag;
    return;
  }
  for (int c = 0; c < 3; ++c) {
    const float* ch = at0 + c * v.plane;
    const float centre = ch[ctr];
    const float s = wsum9([&](int off) { return ch[off]; }, t0, ctr);
    o[c] = st.code == MC_EMBOSS ? s : __fadd_rn(centre, __fmul_rn(st.p[0], s));
  }
}

// The stencil at block pixel (r, cc): v's pixel (0, 0) is the block's
// (-R, -R), so term position pos (dy * 64 + dx) is v's (r + dy, cc + dx).
__device__ __forceinline__ void stencil_op(const McStage& st, const View& v, const float* taps,
                                           const int* idx, int r, int cc, float* o) {
  const int R = st.rh;
  const float* at0 = v.p + r * v.pitch + cc;
  auto at = [&](int c, int pos) { return at0[c * v.plane + (pos >> 6) * v.pitch + (pos & 63)]; };
  const int ctr = R * 64 + R;
  o[3] = at(3, ctr);
  switch (st.code) {
    case MC_SHARPEN:
    case MC_EMBOSS:
      for (int c = 0; c < 3; ++c) {
        const float centre = at(c, ctr);
        const float s = wsum_ordered(
            [&](int k) { return k < 0 ? centre : at(c, idx[st.t0 + k]); }, taps + st.t0, st.n0);
        o[c] = st.code == MC_EMBOSS ? s : __fadd_rn(centre, __fmul_rn(st.p[0], s));
      }
      return;
    case MC_SOBEL: {
      auto y = [&](int pos) { return luma(at(0, pos), at(1, pos), at(2, pos)); };
      const float gxs = wsum_ordered([&](int k) { return y(k < 0 ? ctr : idx[st.t0 + k]); },
                                     taps + st.t0, st.n0);
      const float gys = wsum_ordered([&](int k) { return y(k < 0 ? ctr : idx[st.t1 + k]); },
                                     taps + st.t1, st.n1);
      const float mag =
          __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(gxs, gxs), __fmul_rn(gys, gys))), st.p[0]);
      for (int c = 0; c < 3; ++c) o[c] = mag;
      return;
    }
    case MC_MEDIAN3:
      for (int c = 0; c < 3; ++c) {
        float m[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) m[k] = at(c, (k / 3) * 64 + k % 3);
        o[c] = median9(m);
      }
      return;
  }
  for (int c = 0; c < 4; ++c) o[c] = __int_as_float(0x7fc00000);
}

// Outputs j < kRun of a 1-D correlation at stride `step`: acc[j] is the
// sum over k < n of src[(j + k) * step] * w[k], accumulated with FMAs in
// ascending k from 0.  A register window slides over the source: each
// value loads once, and the kRun values and weights of the next chunk of
// taps load before the FMAs of this one.  Reads stop at `avail` values;
// the zeros past it reach only outputs past the run's valid end.
__device__ __forceinline__ void conv_run(const float* __restrict__ src, int step, int avail,
                                         const float* __restrict__ w, int n, float* acc) {
  float v[2 * kRun - 1], wc[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.f;
#pragma unroll
  for (int m = 0; m < 2 * kRun - 1; ++m) v[m] = m < avail ? src[m * step] : 0.f;
#pragma unroll
  for (int m = 0; m < kRun; ++m) wc[m] = m < n ? w[m] : 0.f;
  for (int k0 = 0; k0 < n; k0 += kRun) {
    float next[kRun], wn[kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const int k = k0 + 2 * kRun - 1 + m;
      next[m] = k < avail ? src[k * step] : 0.f;
      wn[m] = k0 + kRun + m < n ? w[k0 + kRun + m] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kRun; ++kk) {
      if (k0 + kk < n) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) acc[j] = fmaf(v[j + kk], wc[kk], acc[j]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRun - 1; ++m) v[m] = v[m + kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      v[kRun - 1 + m] = next[m];
      wc[m] = wn[m];
    }
  }
}

// f(r, c) for each cell of a rows x cols block, item threadIdx.x + k
// blockDim.x, lanes on consecutive cells; no division in the loop.
template <typename F>
__device__ __forceinline__ void for_each_cell(int rows, int cols, F f) {
  const int n = rows * cols;
  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// kAffine: the plan has MC_AFFINE stages (synthesized GLSL convs and
// stencils); kGlsl > 0: it has MC_GLSL stages (point shaders, with the
// affine ones), evaluated kGlsl (2 or 4) pixels a thread, or reads in
// zero mode; kTrig: an op list calls sinf, cosf or tanf; kExt: it has
// loops, shifts, bit casts or reads a third image; kWide: the lists are
// in the wide op word, one pixel a thread, their files in device memory;
// kGather: a list gathers from the kernel input (launch_form).
// The builtins' and affine forms keep the edge mode's code alone (a
// runtime zero flag cost the affine form 1.5% on glsl-blur-sharpen,
// PERF.md).
// A block's file in device memory (the wide form): the first free slot
// from one its place in the grid picks, taken with a compare-and-swap.  At
// most file_slots blocks are resident at once (the occupancy calculator's
// count), so a slot frees as a block ends; a block that finds none after
// 2^26 tries traps rather than hang the card.
__device__ __forceinline__ int take_file(int* locks, int slots) {
  int s = (int)((blockIdx.y * gridDim.x + blockIdx.x) % (unsigned)slots);
  for (int tries = 0; atomicCAS(locks + s, 0, 1) != 0; ++tries) {
    if (tries == (1 << 26)) __trap();
    s = s + 1 == slots ? 0 : s + 1;
  }
  __threadfence();
  return s;
}

template <typename T, bool kAffine, int kGlsl, bool kTrig, bool kExt, bool kWide,
          bool kGather = false>
__global__ void __launch_bounds__(kThreads, 2)
graph_strip_mc_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int TH, int TW,
                      int vec, int store, float time, const float* __restrict__ taps_g,
                      const int* __restrict__ idx_g, const __grid_constant__ McArgs args,
                      const __grid_constant__ GlslArgs glsl_args) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float dense[kMcMaxStages][kDense];
  const int y0 = (int)blockIdx.y * TH, x0 = (int)blockIdx.x * TW;
  const RunTile in_t = run_tile(H, W, args.in_eh, args.in_ew, TH, TW, y0, x0, kAlign);
  const McGeo g{args.height, W, TH, TW, y0, x0, in_t.lo, in_t.wp};
  const size_t plane = (size_t)H * W;
  float* scratch = sm + args.scratch_off;
  float* taps = sm + args.taps_off;
  int* idx = reinterpret_cast<int*>(taps + args.n_taps);
  float* win = sm + args.win_off;
  const bool zero = kGlsl > 0 && args.zero != 0;

  if (args.in_used) {
    const int in_plane = in_t.wrows() * in_t.wp;
    for (int c = 0; c < 4; ++c)
      load_window_async<T>(x + c * plane, in_t, zero, vec, sm + c * in_plane);
  }
  copy_to_shared(taps_g, args.n_taps, taps);
  for (int i = threadIdx.x; i < args.n_taps; i += blockDim.x) idx[i] = idx_g[i];
  for (int i = threadIdx.x; i < args.n_stages * kDense; i += blockDim.x) {
    const int s = i / kDense, k = i - s * kDense;
    const McStage& st = args.st[s];
    float v = 0.f;
    if (st.kind == MC_POINT && !(kGlsl > 0 && st.code == MC_GLSL))
      for (int t = 0; t < st.n0; ++t) {
        const int pos = idx_g[st.t0 + t];
        if ((pos >> 6) * 3 + (pos & 63) == k) v = taps_g[st.t0 + t];
      }
    dense[s][k] = v;
  }
  [[maybe_unused]] int file = 0;  // the wide form's file in device memory, this block's
  if constexpr (kWide) {
    __shared__ int taken;
    if (threadIdx.x == 0) taken = take_file(glsl_args.file_locks, glsl_args.file_slots);
    __syncthreads();
    file = taken;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < args.n_stages; ++s) {
    const McStage st = args.st[s];
    const int rows = TH + 2 * st.eh, cols = TW + 2 * st.ew;
    const int by = y0 - st.eh, bx = x0 - st.ew;  // image pixel of block (0, 0)
    const int dpitch = pitch(cols), dplane = rows * dpitch;
    // Block pixel (r, cc), in the image, channel c.
    auto put = [&](int c, int r, int cc, float v) RF_INLINE {
      if (st.store) v = store_round(v, store);
      if (st.out_off < 0)
        out[c * plane + (size_t)(by + r) * W + bx + cc] = from_f32<T>(v);
      else
        sm[st.out_off + c * dplane + r * dpitch + cc] = v;
    };
    if (st.kind == MC_CONV) {
      const int rh = st.rh, rw = st.rw, nh = 2 * rh + 1, nw = 2 * rw + 1;
      const int tcols = cols + 2 * rw, sp = pitch(tcols);
      const float* wh = taps + st.t0;
      const float* ww = taps + st.t1;
      // The H pass's source from block pixel (-rh, -rw): channel c of a
      // pool slot or of the input block, or, for the kernel input, its
      // window in buffer c & 1.
      const bool windowed = st.in0.off == kMcGlobal;
      const RunTile wt = run_tile(H, W, st.eh + rh, st.ew + rw, TH, TW, y0, x0, kAlign);
      const View src = windowed ? View{win + wt.lo, wt.wp, args.win_floats}
                                : view(sm, st.in0, g, st.eh + rh, st.ew + rw);
      const bool has_x = st.xs.off != kMcNone;
      const View xv = has_x ? view(sm, st.xs, g, st.eh, st.ew) : View{nullptr, 0, 0};
      // Two window buffers: channel c + 1's copy is in flight while the
      // block convolves channel c.  One: each channel's copy waits for the
      // H pass of the one before, beside the W pass of that one.
      const bool two = args.n_win == 2;
      if (windowed && two) load_window_async<T>(x, wt, zero, vec, win);
      const int n_h = (rows + kRun - 1) / kRun * tcols;
      const int n_w = rows * ((cols + kRun - 1) / kRun);
      // kRun rows of one column of channel c's H pass (lanes on
      // consecutive columns) into scratch half c & 1.
      auto h_item = [&](int c, int i) RF_INLINE {
        float acc[kRun];
        const int rr = i / tcols, cc = i - rr * tcols, r0 = rr * kRun, nv = min(kRun, rows - r0);
        const int sc = windowed ? (two ? c & 1 : 0) : c;
        const float* s0 = src.p + sc * src.plane + r0 * src.pitch + cc;
        if (nv == kRun)
          run_conv(s0, src.pitch, nh, wh, acc);
        else
          conv_run(s0, src.pitch, nv + nh - 1, wh, nh, acc);
        float* d = scratch + (c & 1) * rows * sp + r0 * sp + cc;
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (j < nv) d[j * sp] = acc[j];
      };
      // kRun columns of one row of channel c's W pass (lanes on consecutive
      // rows) from scratch half c & 1, through the epilogue.
      auto w_item = [&](int c, int k) RF_INLINE {
        float acc[kRun];
        const int r = k % rows, c0 = k / rows * kRun, nv = min(kRun, cols - c0);
        const float* s0 = scratch + (c & 1) * rows * sp + r * sp + c0;
        if (nv == kRun)
          run_conv(s0, 1, nw, ww, acc);
        else
          conv_run(s0, 1, nv + nw - 1, ww, nw, acc);
        const int gy = by + r;
        if (gy < 0 || gy >= H) return;
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int cc = c0 + j, gx = bx + cc;
          if (j < nv && gx >= 0 && gx < W) {
            const float xval = has_x ? xv.p[c * xv.plane + r * xv.pitch + cc] : 0.f;
            put(c, r, cc, conv_epilogue(st.code, c, acc[j], xval, st.p));
          }
        }
      };
      for (int ph = 0; ph <= 4; ++ph) {
        const int c_h = ph < 4 ? ph : -1, c_w = ph - 1;
        if (windowed && !two) {
          // One buffer: channel ph's copy lands while the block runs the W
          // pass of channel ph - 1; the H pass of channel ph waits for it.
          __syncthreads();
          if (c_h >= 0) load_window_async<T>(x + c_h * plane, wt, zero, vec, win);
          if (c_w >= 0)
            for (int k = threadIdx.x; k < n_w; k += blockDim.x) w_item(c_w, k);
          cp_async_wait_all();
          __syncthreads();
          if (c_h >= 0)
            for (int i = threadIdx.x; i < n_h; i += blockDim.x) h_item(c_h, i);
          continue;
        }
        // This channel's window has landed; the last phase's reads of the
        // scratch half and window buffer reused now are done.
        if (windowed) cp_async_wait_all();
        __syncthreads();
        if (windowed && ph < 3)
          load_window_async<T>(x + (ph + 1) * plane, wt, zero, vec,
                               win + ((ph + 1) & 1) * args.win_floats);
        const int items = (c_h >= 0 ? n_h : 0) + (c_w >= 0 ? n_w : 0);
        for (int i = threadIdx.x; i < items; i += blockDim.x) {
          if (c_h >= 0 && i < n_h)
            h_item(c_h, i);
          else
            w_item(c_w, i - (c_h >= 0 ? n_h : 0));
        }
      }
    } else {
      const View in0 = st.kind == MC_STENCIL ? view(sm, st.in0, g, st.eh + st.rh, st.ew + st.rh)
                                             : view(sm, st.in0, g, st.eh, st.ew);
      const View in1 = st.n_in > 1 ? view(sm, st.in1, g, st.eh, st.ew) : in0;
      const float* m = dense[s];
      const float q4 = st.n0 > 0 ? taps[st.t0] : 0.f;
      // Sharpen, emboss and sobel of 3x3 tables: their term lists in
      // registers for the whole stage.
      const bool small = st.kind == MC_STENCIL && st.code != MC_MEDIAN3 && st.n0 <= kTerms9 &&
                         st.n1 <= kTerms9;
      Terms9 l0{}, l1{};
      if (small) {
        l0 = terms9(taps, idx, st.t0, st.n0, in0.pitch);
        l1 = terms9(taps, idx, st.t1, st.n1, in0.pitch);
      }
      // A GLSL point shader's op list (the glsl form only): its register
      // files overlay the conv windows and scratch.
      bool glsl = false;
      if constexpr (kGlsl > 0) {
        glsl = st.code == MC_GLSL;
        if (glsl) {
          float* files = win;
          if constexpr (kWide) files = glsl_args.files + (size_t)file * glsl_args.file_floats;
          glsl_cells<kGlsl, kTrig, kExt, kWide, kGather>(
              idx + st.t0, files, in0, in1, rows, cols, by, bx, H, W, args.row0, time, sm,
              glsl_args.in + 3 * st.t1, GlslGatherSrc<T>{x, H, W}, put);
        }
      }
      if (!glsl) for_each_cell(rows, cols, [&](int r, int cc) RF_INLINE {
        const int gy = by + r, gx = bx + cc;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) return;
        float o[4];
        if (small) {
          stencil_op9(st, in0, l0, l1, r, cc, o);
        } else if (st.kind == MC_STENCIL) {
          stencil_op(st, in0, taps, idx, r, cc, o);
        } else {
          float a[4], b[4];
          const int at0 = r * in0.pitch + cc, at1 = r * in1.pitch + cc;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            a[c] = in0.p[c * in0.plane + at0];
            b[c] = st.n_in > 1 ? in1.p[c * in1.plane + at1] : 0.f;
          }
          point_op<kAffine>(st, a, b, m, q4, g, gy + args.row0, gx, o);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) put(c, r, cc, o[c]);
      });
    }
    // A slot whose block crosses the image's edge: its outside cells take
    // the clamped pixel's value, so that consumers read it unclamped.
    if (st.out_off >= 0 && (by < 0 || bx < 0 || by + rows > H || bx + cols > W)) {
      __syncthreads();
      float* d = sm + st.out_off;
      for_each_cell(rows, cols, [&](int r, int cc) RF_INLINE {
        const int gy = by + r, gx = bx + cc;
        const int cy = min(max(gy, 0), H - 1), cx = min(max(gx, 0), W - 1);
        if (cy == gy && cx == gx) return;
        const int from = (cy - by) * dpitch + cx - bx, to = r * dpitch + cc;
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c * dplane + to] = d[c * dplane + from];
      });
    }
    __syncthreads();
  }
  if constexpr (kWide) {
    // The file frees once every write to it is visible past this block.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(glsl_args.file_locks + file, 0);
  }
}

template <typename T, bool kAffine, int kGlsl, bool kTrig = false, bool kExt = false,
          bool kWide = false, bool kGather = false>
static int launch(const void* x, void* out, int H, int W, int TH, int TW, int vec,
                  const McArgs& args, const GlslArgs& glsl, const float* taps, const int* idx,
                  int store, float time, int smem, cudaStream_t stream) {
  auto kernel = graph_strip_mc_kernel<T, kAffine, kGlsl, kTrig, kExt, kWide, kGather>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), H, W,
                                           TH, TW, vec, store, time, taps, idx, args, glsl);
  return (int)cudaGetLastError();
}

// The kernel form of a plan, chosen here only: the glsl form where a stage
// is MC_GLSL, at the plan's pixels a thread (4, else 2), with the trig ops
// where an op list calls them and the ops of loops, shifts, bit casts and
// inputs past the second where one has them (the flags of the packed
// header), and for zero mode, which rides on it (the
// other forms read the edge mode only); else the affine form where a
// stage is MC_AFFINE; else the builtins'.  Lists in the wide op word take
// the wide form alone, one pixel a thread with every op.  Lists that gather
// take a gather form: at the plan's pixels a thread, with no other extra
// ops, or with the trig ops and those of loops, shifts, bit casts and
// inputs past the second together where a list has either (no wide
// gather form: the planner refuses such a plan).
template <typename T>
static int launch_form(const void* x, void* out, int H, int W, int TH, int TW, int vec,
                       const McArgs& args, const GlslArgs& ga, const float* taps, const int* idx,
                       int store, float time, int smem, cudaStream_t stream) {
  bool glsl = args.zero != 0, affine = false;
  for (int s = 0; s < args.n_stages; ++s) {
    glsl = glsl || args.st[s].code == MC_GLSL;
    affine = affine || args.st[s].code == MC_AFFINE;
  }
  const bool four = args.glsl_pix == 4, trig = args.glsl_flags & 1, ext = args.glsl_flags & 2;
  if (glsl && (args.glsl_flags & 8)) {
    if (args.glsl_flags & 4) return (int)cudaErrorInvalidValue;
    if (four && (trig || ext))
      return launch<T, true, 4, true, true, false, true>(x, out, H, W, TH, TW, vec, args, ga,
                                                         taps, idx, store, time, smem, stream);
    if (four)
      return launch<T, true, 4, false, false, false, true>(x, out, H, W, TH, TW, vec, args, ga,
                                                           taps, idx, store, time, smem, stream);
    if (trig || ext)
      return launch<T, true, 2, true, true, false, true>(x, out, H, W, TH, TW, vec, args, ga,
                                                         taps, idx, store, time, smem, stream);
    return launch<T, true, 2, false, false, false, true>(x, out, H, W, TH, TW, vec, args, ga,
                                                         taps, idx, store, time, smem, stream);
  }
  if (glsl && (args.glsl_flags & 4))
    return launch<T, true, 1, true, true, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx,
                                                store, time, smem, stream);
  if (glsl && four && trig && ext)
    return launch<T, true, 4, true, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store,
                                          time, smem, stream);
  if (glsl && four && trig)
    return launch<T, true, 4, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time,
                                    smem, stream);
  if (glsl && four && ext)
    return launch<T, true, 4, false, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store,
                                           time, smem, stream);
  if (glsl && four)
    return launch<T, true, 4>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time, smem,
                              stream);
  if (glsl && trig && ext)
    return launch<T, true, 2, true, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store,
                                          time, smem, stream);
  if (glsl && trig)
    return launch<T, true, 2, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time,
                                    smem, stream);
  if (glsl && ext)
    return launch<T, true, 2, false, true>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store,
                                           time, smem, stream);
  if (glsl)
    return launch<T, true, 2>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time, smem,
                              stream);
  if (affine)
    return launch<T, true, 0>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time, smem,
                              stream);
  return launch<T, false, 0>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time, smem,
                             stream);
}

}  // namespace rf

// stage_i / stage_f are host arrays (kMcStageInts ints and 4 floats per
// stage); geo the layout's ten ints (scratch_off, taps_off, in_eh,
// in_ew, in_used, win_off, win_floats, n_win, glsl_pix, glsl_flags (1
// trig, 2 loops and the like, 4 the wide op word, 8 gathers):
// cuda_ops.McProgram.geometry); glsl_in the host table of n_glsl_in
// views (three ints each: offset, pitch, plane) of the MC_GLSL stages'
// inputs past the second; files / locks the wide form's register files
// in device memory (file_slots files of file_floats floats, the lock
// words zero), null for the other forms; taps / idx lie on the device.  bf16 selects bf16 storage for input and
// output (else f32).  vec: the input's rows start on 16-byte boundaries;
// zero: the plan's border mode is "zero".  x is a slab of H rows whose first
// row is image row row0 of an image of height rows (0 and H for a frame).
extern "C" int rf_graph_strip_mc(int bf16, const void* x, void* out, int H, int W, int TH, int TW,
                                 const int* geo, const int* stage_i, const float* stage_f,
                                 int n_stages, const float* taps, const int* idx, int n_taps,
                                 int store, float time, int vec, int zero, int row0, int height,
                                 int smem, const int* glsl_in, int n_glsl_in, void* files,
                                 int* locks, int file_slots, int file_floats, void* stream) {
  const bool wide = geo[9] & 4;
  if (n_stages < 1 || n_stages > rf::kMcMaxStages || n_glsl_in < 0 ||
      n_glsl_in > rf::kMcGlslInputs || (wide && (files == nullptr || locks == nullptr ||
                                                 file_slots < 1)))
    return (int)cudaErrorInvalidValue;
  rf::McArgs args{};
  args.n_stages = n_stages;
  args.scratch_off = geo[0];
  args.taps_off = geo[1];
  args.in_eh = geo[2];
  args.in_ew = geo[3];
  args.in_used = geo[4];
  args.win_off = geo[5];
  args.win_floats = geo[6];
  args.n_win = geo[7];
  args.glsl_pix = geo[8];
  args.glsl_flags = geo[9];
  rf::GlslArgs ga{};
  for (int k = 0; k < 3 * n_glsl_in; ++k) ga.in[k] = glsl_in[k];
  ga.files = static_cast<float*>(files);
  ga.file_locks = locks;
  ga.file_slots = file_slots;
  ga.file_floats = file_floats;
  args.n_taps = n_taps;
  args.zero = zero;
  args.row0 = row0;
  args.height = height;
  for (int s = 0; s < n_stages; ++s) {
    const int* v = stage_i + s * rf::kMcStageInts;
    rf::McStage& st = args.st[s];
    st.kind = v[0];
    st.code = v[1];
    st.n_in = v[2];
    st.in0 = {v[3], v[4], v[5]};
    st.in1 = {v[6], v[7], v[8]};
    st.xs = {v[9], v[10], v[11]};
    st.out_off = v[12];
    st.eh = v[13];
    st.ew = v[14];
    st.rh = v[15];
    st.rw = v[16];
    st.t0 = v[17];
    st.n0 = v[18];
    st.t1 = v[19];
    st.n1 = v[20];
    st.store = v[21];
    for (int k = 0; k < 4; ++k) st.p[k] = stage_f[4 * s + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return rf::launch_form<__nv_bfloat16>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store,
                                          time, smem, s);
  return rf::launch_form<float>(x, out, H, W, TH, TW, vec, args, ga, taps, idx, store, time, smem,
                                s);
}

// 0: stages per plan; 1: ints per stage; 2: the op lists' inputs past
// the second (cuda_ops.MC_MAX_STAGES, MC_STAGE_INTS, MC_GLSL_INPUTS).
extern "C" int rf_mc_limits(int which) {
  return which == 0 ? rf::kMcMaxStages : which == 1 ? rf::kMcStageInts : rf::kMcGlslInputs;
}

// Blocks of the wide glsl form (bf16 or f32 storage, smem bytes of dynamic
// shared memory) the current card holds at once: the occupancy
// calculator's blocks an SM times its SMs; a CUDA error as its negative.
namespace rf {
template <typename T>
static int wide_resident(int smem) {
  auto kernel = graph_strip_mc_kernel<T, true, 1, true, true, true>;
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks * sms : -(int)err;
}
}  // namespace rf

extern "C" int rf_mc_resident(int bf16, int smem) {
  return bf16 ? rf::wide_resident<__nv_bfloat16>(smem) : rf::wide_resident<float>(smem);
}
