// One instantiation of the whole-encoder tower's kernel (csrc/encoder_tower.cu describes it): the
// bf16 tower, its bf16 attention with the N = 16 tail (a last key block of at most 16 keys).
#include "encoder_tower.cuh"

tower::TowerKernel tower::kernel_bf16_narrow() {
  return encoder_tower_kernel<false, true>;
}
