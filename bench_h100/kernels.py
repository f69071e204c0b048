"""Device records of a traced run by who wrote the kernel: `library` (the
contraction libraries: cuDNN's convolutions with their layout transforms,
cuBLAS's and CUTLASS's GEMMs), `native` (PyTorch's own kernels,
`at::native` and the CUB kernels PyTorch instantiates), `port` (the port's
own, `profile.PORT_KERNELS`) and `copy` (memcpy and memset records). A
library is whatever is none of the other three: its kernels' names vary
with the library's version and the algorithm it picks.

`RECORDED` holds the names (their first 160 characters, as
`profile.NAME_CHARS`) that a traced replayed run of resnet_50.batch128
recorded, each with its class, longest device time first (H100 80GB HBM3,
700 W; torch 2.11, CUDA 12.8, cuDNN 9.22); the tests hold the classifier to
them."""
from __future__ import annotations

from .profile import PORT_KERNELS

KINDS = ("library", "native", "port", "copy")
_NATIVE = ("at::native::", "at_cuda_detail::", "at::cuda::")
_COPY = ("Memcpy", "Memset")

RECORDED = (
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_ti"
     "lesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_exec"
     "ute_kernel__5x_cudnn", "library"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::CUDAFunctor_add<float> >(at::TensorIt"
     "eratorBase&, at::native::CUDAFun", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIte"
     "ratorBase&)::{lambda()#3}::opera", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::BinaryFunctor<float, float, float, at"
     "::native::binary_internal::MulFu", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::BinaryFunctor<float, float, float, at"
     "::native::maximum_kernel_cuda(at", "native"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::gp"
     "u_index_kernel<at::native::index_kernel_impl<at::native::OpaqueT"
     "ype<4> >(at::TensorIteratorBase&", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CU"
     "DAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::arr", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIte"
     "ratorBase&)::{lambda()#3}::opera", "native"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::"
     "native::_cuda_scatter_gather_internal_kernel<false, at::native::"
     "OpaqueType<4>, long>::operator()", "native"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize64x64x8_stage3_"
     "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas", "library"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, "
     "1, false, false, true>(int, int, int, float const*, int, float*,"
     " float const*, kernel_conv_param", "library"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::(anonymous namespace)::where_kernel_i"
     "mpl(at::TensorIterator&)::{lambd", "native"),
    ("void at::native::(anonymous namespace)::indexSelectSmallIndex<fl"
     "oat, long, unsigned int, 3, 3, -2>(at::cuda::detail::TensorInfo<"
     "float, unsigned int>, at::cuda::", "native"),
    ("void fft2d_r2c_16x16<float>(float2*, float const*, int, int, int"
     ", int, int, int, int, int)", "library"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<floa"
     "t, at::native::func_wrapper_t<float, at::native::MaxNanFunctor<f"
     "loat> >, unsigned int, float, 4,", "native"),
    ("void flip_filter<float, float>(float*, float const*, int, int, i"
     "nt, int)", "library"),
    ("void fft2d_c2r_16x16<float, false>(float*, float2*, int, int, in"
     "t, int, int, int, int, int, int, int, float, float, int, cudnnAc"
     "tivationStruct, float*, float*)", "library"),
    ("void fft2d_r2c_32x32<float, false, 0u, false>(float2*, float con"
     "st*, int, int, int, int, int, int, int, int, int, cudnn::reduced"
     "_divisor, bool, int2, int, int)", "library"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::CU"
     "DAFunctorOnSelf_add<long>, std::array<char*, 2ul> >(int, at::nat"
     "ive::CUDAFunctorOnSelf_add<long>", "native"),
    ("void fft2d_c2r_32x32<float, false, false, 0u, false, false>(floa"
     "t*, float2 const*, int, int, int, int, int, int, int, int, int, "
     "float, float, cudnn::reduced_div", "library"),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float con"
     "st*, int, int, int, int, int, int, int, int, int, cudnn::reduced"
     "_divisor, bool, int2, int, int)", "library"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kern"
     "el_impl_nocast<at::native::(anonymous namespace)::CompareFunctor"
     "<int> >(at::TensorIteratorBase&,", "native"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::(a"
     "nonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&"
     ", c10::Scalar, c10::Scalar, at::", "native"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, a"
     "t::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const"
     "&, c10::Scalar const&, at::Tenso", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Fi"
     "llFunctor<int>, std::array<char*, 1ul> >(int, at::native::FillFu"
     "nctor<int>, std::array<char*, 1u", "native"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kern"
     "el_impl_nocast<at::native::BinaryFunctor<bool, bool, bool, at::n"
     "ative::logical_and_kernel_cuda(a", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Fi"
     "llFunctor<float>, std::array<char*, 1ul> >(int, at::native::Fill"
     "Functor<float>, std::array<char*", "native"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::AU"
     "naryFunctor<long, long, long, at::native::binary_internal::MulFu"
     "nctor<long> >, std::array<char*,", "native"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, a"
     "t::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const"
     "&, c10::Scalar const&, at::Tenso", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Bi"
     "naryFunctor<bool, bool, bool, at::native::logical_and_kernel_cud"
     "a(at::TensorIterator&)::{lambda(", "native"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<floa"
     "t, at::native::func_wrapper_t<float, at::native::sum_functor<flo"
     "at, float, float>::operator()(at", "native"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_war"
     "psize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "library"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<floa"
     "t, at::native::func_wrapper_t<float, at::native::MaxNanFunctor<f"
     "loat> >, unsigned int, float, 4,", "native"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_"
     "copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operato"
     "r()() const::{lambda()#4}::opera", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::BinaryFunctor<float, float, float, at"
     "::native::binary_internal::DivFu", "native"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_war"
     "psize1x4x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cubla"
     "s", "library"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<floa"
     "t, at::native::func_wrapper_t<float, at::native::sum_functor<flo"
     "at, float, float>::operator()(at", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::ex"
     "p_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator()"
     "() const::{lambda()#2}::operator", "native"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kern"
     "el_impl_nocast<at::native::CUDAFunctor_add<int> >(at::TensorIter"
     "atorBase&, at::native::CUDAFunct", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CU"
     "DAFunctorOnSelf_add<int>, std::array<char*, 2ul> >(int, at::nati"
     "ve::CUDAFunctorOnSelf_add<int>, ", "native"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AU"
     "naryFunctor<int, int, int, at::native::binary_internal::MulFunct"
     "or<int> >, std::array<char*, 2ul", "native"),
)


def kind(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port"
    if name.startswith(_COPY):
        return "copy"
    if any(k in name for k in _NATIVE):
        return "native"
    return "library"


def is_library(name: str) -> bool:
    return kind(name) == "library"
