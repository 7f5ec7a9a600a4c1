// One instantiation of the whole-encoder tower's kernel (csrc/encoder_tower.cu describes it): the
// W8A8 tower.
#include "encoder_tower.cuh"

tower::TowerKernel tower::kernel_s8() {
  return encoder_tower_kernel<true, false>;
}
