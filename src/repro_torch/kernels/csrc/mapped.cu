// Mapped page-locked host memory for the USM data plane.
//
// `host_register_mapped` page-locks an existing host range and maps it into
// the device's address space, so a kernel reads and writes it in place over
// PCIe with no staging copy; `host_device_pointer` gives the device address
// of a mapped host pointer; `host_unregister` undoes a registration.
#include <cuda_runtime.h>

extern "C" int host_register_mapped(void* ptr, long long nbytes) {
  cudaError_t err = cudaHostRegister(ptr, (size_t)nbytes,
                                     cudaHostRegisterMapped);
  if (err != cudaSuccess) cudaGetLastError();  // keep later checks clean
  return (int)err;
}

extern "C" int host_device_pointer(void* ptr, void** dev_ptr) {
  cudaError_t err = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int host_unregister(void* ptr) {
  cudaError_t err = cudaHostUnregister(ptr);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
