"""cli/profile_m_step's grouping of kernel names: each of the port's
kernels lands in its own group (by its mangled or demangled name) before
the library fragments are tried, so none of them counts as cuBLAS."""

import pytest

from vlm_clip_tpu_torch.cli.profile_m_step import _group

NS = "(anonymous namespace)::"


@pytest.mark.parametrize("name,group", [
    (NS + "pnmlp_ln_fwd_kernel(__nv_bfloat16 const*, float const*)",
     "K3 bwd"),
    ("_ZN49_GLOBAL__N__a66b3b54_16_fused_adapter_cu_9e7b35ab23pnmlp_bwd_"
     "hidden_kernelEPK13__nv_bfloat16S2_S2_PKfS2_PS0_S5_Pfiii", "K3 bwd"),
    (NS + "pnmlp_bwd_du_kernel(__nv_bfloat16 const*, float*, int)",
     "K3 bwd"),
    (NS + "pnmlp_bwd_ln_kernel(__nv_bfloat16 const*, float*, int)",
     "K3 bwd"),
    (NS + "prenorm_mlp_bwd_kernel<float>(float const*, int)", "K3 bwd"),
    (NS + "prenorm_mlp_fwd_kernel<__nv_bfloat16>(int)", "K3 fwd"),
    (NS + "wgrad_mma_kernel<true>(__nv_bfloat16 const*, int)",
     "K1-K3 bwd weight grads"),
    (NS + "wgrad_kernel<float, float>(float const*, int)",
     "K1-K3 bwd weight grads"),
    (NS + "split_sum_kernel(float const*, int, unsigned long, float*)",
     "K1-K3 bwd weight grads"),
    (NS + "colsum_kernel(float const*, int, int, float*)",
     "K1-K3 bwd column sums"),
    (NS + "cross_attn_block_bwd_kernel<__nv_bfloat16>(int)", "K2 bwd"),
    (NS + "cab_bwd_attn_kernel(__nv_bfloat16 const*, float, int)", "K2 bwd"),
    (NS + "cab_bwd_attn_kernel<128>(__nv_bfloat16 const*, float, int)",
     "K2 bwd"),
    (NS + "cross_attn_block_fwd_kernel<__nv_bfloat16, 16>(int)", "K2 fwd"),
    (NS + "cab_fwd_t_kernel(__nv_bfloat16 const*, float*, int)", "K2 fwd"),
    (NS + "cab_fwd_ln_kernel(float const*, float const*)", "K2 fwd"),
    (NS + "cab_fwd_q_kernel(__nv_bfloat16 const*, int, int)", "K2 fwd"),
    (NS + "cab_fwd_attn_kernel<64>(__nv_bfloat16 const*, float, int)",
     "K2 fwd"),
    ("_ZN49_GLOBAL__N__a66b3b54_16_fused_adapter_cu_9e7b35ab18cab_fwd_out_"
     "kernelEPK13__nv_bfloat16S2_PKfS4_S4_S4_S4_S4_PS0_ii", "K2 fwd"),
    (NS + "cross_attn_block_bwd_kernel<float, 8>(float const*, int)",
     "K2 bwd"),
    (NS + "cab_bwd_ln_fwd_kernel(float const*, float const*)", "K2 bwd"),
    (NS + "cab_bwd_t_kernel(__nv_bfloat16 const*, float*, int)", "K2 bwd"),
    (NS + "pnmlp_fwd_ln_kernel(__nv_bfloat16 const*, int, int)", "K3 fwd"),
    ("_ZN49_GLOBAL__N__a66b3b54_16_fused_adapter_cu_9e7b35ab23pnmlp_fwd_"
     "hidden_kernelEPK13__nv_bfloat16S2_PKfPS0_iii", "K3 fwd"),
    (NS + "pnmlp_fwd_out_kernel(__nv_bfloat16 const*, int)", "K3 fwd"),
    (NS + "seqbwd_pre_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
     "K1 bwd"),
    (NS + "seqbwd_z_kernel<float>(float const*, float const*, int)",
     "K1 bwd"),
    (NS + "seqbwd_ln_kernel<__nv_bfloat16>(float*, float, int)", "K1 bwd"),
    ("_ZN49_GLOBAL__N__a66b3b54_16_fused_adapter_cu_9e7b35ab18seqbwd_dpre_"
     "kernelEPKfS1_S1_PfS2_iii", "K1 bwd"),
    (NS + "seqbwd_dx_kernel<float>(float const*, float*, int)", "K1 bwd"),
    (NS + "seq_adapter_bwd_kernel<float>(float const*, int)", "K1 bwd"),
    (NS + "seqfwd_pre_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
     "K1 fwd"),
    (NS + "seqfwd_z_kernel<__nv_bfloat16>(float const*, float const*, int)",
     "K1 fwd"),
    ("_ZN49_GLOBAL__N__a66b3b54_16_fused_adapter_cu_9e7b35ab15seqfwd_z_"
     "kernelIfEEvPKfS2_PKT_S2_Pfiii", "K1 fwd"),
    (NS + "seqfwd_ln_kernel<float>(float const*, float const*, int)",
     "K1 fwd"),
    (NS + "seq_adapter_fwd_kernel<float>(float const*, int)", "K1 fwd"),
    (NS + "wgrad_tf32_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
     "K1-K3 bwd weight grads"),
    (NS + "wgrad_tf32_kernel<float>(float const*, int, int)",
     "K1-K3 bwd weight grads"),
    (NS + "contrastive_bwd_cluster_kernel<__nv_bfloat16>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, float const*, int, int)",
     "K4 bwd"),
    ("_ZN56_GLOBAL__N__1e2a43d5_14_contrastive_cu_7c0b1f1130contrastive_bwd_"
     "cluster_kernelIfEEvPKT_S3_PKfS5_PS1_S6_Pfii", "K4 bwd"),
    (NS + "dz_kernel(float const*, float const*, float const*, float*, "
     "int)", "K4 bwd"),
    ("_ZN56_GLOBAL__N__1e2a43d5_14_contrastive_cu_7c0b1f119dz_kernelEPKfS1_"
     "S1_Pfi", "K4 bwd"),
    (NS + "norm_bwd_kernel<float>(float const*, float const*, int, int)",
     "K4 bwd"),
    (NS + "dls_kernel(float const*, float const*, float*, int)", "K4 bwd"),
    (NS + "norm_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int, int)",
     "K4 fwd"),
    (NS + "gemm_kernel(float const*, int, int, float const*, int, int, "
     "float*, int, int, int, int, float const*)", "K4 fwd"),
    (NS + "lse_kernel(float const*, float*, int)", "K4 fwd"),
    (NS + "loss_kernel(float const*, float const*, float*, int)",
     "K4 fwd"),
    (NS + "feature_adapter_fwd_cluster_kernel<float>(float const*, int)",
     "K6 fwd"),
    (NS + "feature_adapter_bwd_cluster_kernel<__nv_bfloat16>(int)",
     "K6 bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "cuBLAS/cuDNN products"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopA_NNT", "cuBLAS/cuDNN products"),
    ("void at::native::vectorized_elementwise_kernel<4>()",
     "elementwise and copies"),
])
def test_kernel_names_keep_their_groups(name, group):
    assert _group(name) == group
