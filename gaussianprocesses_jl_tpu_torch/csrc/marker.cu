// Markers: empty kernels whose launches mark points of a stream, so that a
// device trace (torch.profiler's CUPTI records) brackets the work between
// two of them by name. A marker launched while a CUDA graph is captured is a
// node of the graph and runs at every replay, where the host's ranges of
// `utils/profiling.span` do not.
//
// Each bracket tag of `utils/profiling.MARKS` has two kernels, `<tag>_begin`
// and `<tag>_end`, the tag's dots written as underscores; `gp_mark(i, s)`
// launches the i-th of them, in the order of GP_MARKS, on stream s, one
// thread of one block. The order is `MARKS`' order, begin before end.
#include <cuda_runtime.h>

#define GP_MARKS(X) \
  X(gp_qr_fwd_begin) X(gp_qr_fwd_end) X(gp_qr_vjp_begin) X(gp_qr_vjp_end)

#define GP_MARK_KERNEL(name) extern "C" __global__ void name() {}
GP_MARKS(GP_MARK_KERNEL)

#define GP_MARK_ENTRY(name) name,
static void (*const kMarks[])() = {GP_MARKS(GP_MARK_ENTRY)};

extern "C" int gp_mark_count() { return (int)(sizeof(kMarks) / sizeof(kMarks[0])); }

extern "C" int gp_mark(int which, void* stream) {
  if (which < 0 || which >= gp_mark_count()) return (int)cudaErrorInvalidValue;
  kMarks[which]<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
