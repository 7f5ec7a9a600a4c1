// One instantiation of the whole-encoder tower's kernel (csrc/encoder_tower.cu describes it): the
// W8A8 tower, its bf16 attention with the N = 16 tail (a last key block of at most 16 keys).
#include "encoder_tower.cuh"

tower::TowerKernel tower::kernel_s8_narrow() {
  return encoder_tower_kernel<true, true>;
}
