// The float64 instances of the parity assembly kernels
// (parity_assembly.cuh), compiled apart from parity_assembly.cu so that
// nvcc builds the two halves in parallel.
#include "parity_assembly.cuh"

namespace orc {

template int launch_momentum<double>(
    int, int, bool, bool, bool, const AsmCols<double>&, int, int, int, int,
    const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const int*, double, double,
    double, double, void*, void*, void*, long long, cudaStream_t);
template int launch_pc<double>(bool, bool, const AsmCols<double>&, int, int,
                               int, int, const void*, const void*, const void*,
                               const void*, const void*, const int*, double,
                               double, void*, void*, void*, long long,
                               cudaStream_t);

}  // namespace orc
