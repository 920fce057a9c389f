// Generated by tieredstorage_tpu_torch/ops/aes_circuit_gen.py: Boyar and
// Peralta's 115-gate AES S-box (32 AND, 79 XOR, 4 XNOR; SEA 2010) as
// 74 three-input LOP3s. Do not edit: rerun the generator.
#pragma once
#include <cstdint>

// d = the function of (a, b, c) whose truth table is kTable, bit 4a + 2b + c.
template <unsigned kTable>
__device__ __forceinline__ uint32_t tst_lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kTable));
  return d;
}

// x0..x7: bit-planes of one byte position, LSB first; each word carries
// 32 blocks. Replaced in place by the planes of S(x).
__device__ __forceinline__ void tst_sbox(
    uint32_t& x0, uint32_t& x1, uint32_t& x2, uint32_t& x3,
    uint32_t& x4, uint32_t& x5, uint32_t& x6, uint32_t& x7) {
  const uint32_t y14 = tst_lop3<0x66>(x2, x4, x2);
  const uint32_t y13 = tst_lop3<0x66>(x1, x7, x1);
  const uint32_t y9 = tst_lop3<0x66>(x4, x7, x4);
  const uint32_t y8 = tst_lop3<0x66>(x2, x7, x2);
  const uint32_t y1 = tst_lop3<0x96>(x0, x5, x6);
  const uint32_t y12 = tst_lop3<0x66>(y14, y13, y14);
  const uint32_t y2 = tst_lop3<0x66>(x7, y1, x7);
  const uint32_t y5 = tst_lop3<0x66>(x1, y1, x1);
  const uint32_t y15 = tst_lop3<0x96>(x2, x3, y12);
  const uint32_t y20 = tst_lop3<0x96>(x3, x6, y12);
  const uint32_t y6 = tst_lop3<0x66>(x0, y15, x0);
  const uint32_t y10 = tst_lop3<0x96>(x5, x6, y15);
  const uint32_t y11 = tst_lop3<0x66>(y9, y20, y9);
  const uint32_t y17 = tst_lop3<0x66>(y10, y11, y10);
  const uint32_t y16 = tst_lop3<0x96>(x5, x6, y11);
  const uint32_t t3 = tst_lop3<0x28>(y8, y5, y6);
  const uint32_t t4 = tst_lop3<0x6a>(y12, y15, t3);
  const uint32_t t5 = tst_lop3<0x60>(x0, x4, y1);
  const uint32_t t6 = tst_lop3<0x6a>(y12, y15, t5);
  const uint32_t t7 = tst_lop3<0x88>(y13, y16, y13);
  const uint32_t t8 = tst_lop3<0x88>(y1, y5, y1);
  const uint32_t t10 = tst_lop3<0x48>(x0, y2, y11);
  const uint32_t t12 = tst_lop3<0x88>(y9, y11, y9);
  const uint32_t t14 = tst_lop3<0x6a>(y14, y17, t12);
  const uint32_t t16 = tst_lop3<0x6a>(y8, y10, t12);
  const uint32_t t18 = tst_lop3<0x66>(t6, t16, t6);
  const uint32_t t19 = tst_lop3<0x96>(t7, t8, t14);
  const uint32_t t20 = tst_lop3<0x96>(t7, t10, t16);
  const uint32_t t21 = tst_lop3<0x96>(y20, t4, t14);
  const uint32_t t22 = tst_lop3<0x96>(y8, y10, t18);
  const uint32_t t23 = tst_lop3<0x96>(y13, y16, t19);
  const uint32_t t24 = tst_lop3<0x96>(x7, y16, t20);
  const uint32_t t27 = tst_lop3<0x6a>(t21, t23, t24);
  const uint32_t t29 = tst_lop3<0xe4>(t21, t22, t27);
  const uint32_t t31 = tst_lop3<0x6c>(t21, t22, t23);
  const uint32_t t33 = tst_lop3<0xe4>(t23, t24, t31);
  const uint32_t t36 = tst_lop3<0x60>(t24, t27, t33);
  const uint32_t t37 = tst_lop3<0x96>(t23, t33, t36);
  const uint32_t t39 = tst_lop3<0x48>(t27, t29, t36);
  const uint32_t t40 = tst_lop3<0x96>(t21, t22, t39);
  const uint32_t t41 = tst_lop3<0x66>(t37, t40, t37);
  const uint32_t t42 = tst_lop3<0x66>(t29, t33, t29);
  const uint32_t t44 = tst_lop3<0x66>(t33, t37, t33);
  const uint32_t z2 = tst_lop3<0x88>(x0, t33, x0);
  const uint32_t z3 = tst_lop3<0x60>(y16, t29, t40);
  const uint32_t z4 = tst_lop3<0x88>(y1, t40, y1);
  const uint32_t z5 = tst_lop3<0x28>(x0, y11, t29);
  const uint32_t z7 = tst_lop3<0x60>(y17, t41, t42);
  const uint32_t z10 = tst_lop3<0x28>(y8, y5, t37);
  const uint32_t z11 = tst_lop3<0x28>(x4, y1, t33);
  const uint32_t z12 = tst_lop3<0x60>(y13, t29, t40);
  const uint32_t z16 = tst_lop3<0x60>(y14, t41, t42);
  const uint32_t t46 = tst_lop3<0x6a>(y9, t42, z16);
  const uint32_t t48 = tst_lop3<0x6a>(y5, t40, z5);
  const uint32_t t49 = tst_lop3<0x6a>(y12, t44, z10);
  const uint32_t t52 = tst_lop3<0x6a>(y10, t41, z7);
  const uint32_t t53 = tst_lop3<0x6a>(y15, t44, z3);
  const uint32_t t54 = tst_lop3<0x6a>(y11, t42, z7);
  const uint32_t t55 = tst_lop3<0x6a>(y8, t41, z16);
  const uint32_t t57 = tst_lop3<0x96>(z2, z12, t53);
  const uint32_t t61 = tst_lop3<0x6a>(y2, t29, t57);
  const uint32_t t62 = tst_lop3<0x96>(z4, t46, t52);
  const uint32_t t63 = tst_lop3<0x96>(z4, t46, t49);
  const uint32_t t64 = tst_lop3<0x96>(z3, z4, t54);
  const uint32_t t65 = tst_lop3<0x66>(t61, t62, t61);
  const uint32_t t66 = tst_lop3<0x6a>(y6, t37, t63);
  const uint32_t S0 = tst_lop3<0x96>(z3, t54, t63);
  const uint32_t S6 = tst_lop3<0x69>(z12, t48, t62);
  const uint32_t S7 = tst_lop3<0x69>(t46, t48, t57);
  const uint32_t S3 = tst_lop3<0x66>(t53, t66, t53);
  const uint32_t S4 = tst_lop3<0x96>(z2, z5, t66);
  const uint32_t S5 = tst_lop3<0x96>(z10, z11, t65);
  const uint32_t S1 = tst_lop3<0x99>(t64, S3, t64);
  const uint32_t S2 = tst_lop3<0x69>(t55, t64, t65);
  x0 = S7;
  x1 = S6;
  x2 = S5;
  x3 = S4;
  x4 = S3;
  x5 = S2;
  x6 = S1;
  x7 = S0;
}
