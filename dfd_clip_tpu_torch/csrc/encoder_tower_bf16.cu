// One instantiation of the whole-encoder tower's kernel (csrc/encoder_tower.cu describes it): the
// bf16 tower.
#include "encoder_tower.cuh"

tower::TowerKernel tower::kernel_bf16() {
  return encoder_tower_kernel<false, false>;
}
