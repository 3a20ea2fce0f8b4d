// Drives the decode entry points of the port's native host runtime
// (guacamole_tpu_torch/runtime/csrc/) over input files, for
// tests/test_torch_native.py, which builds it with -fsanitize=address.
//
//   native_decode_harness CHUNKS INPUT...
//
// For every INPUT it calls guac_decode_bam, guac_decode_bam_chunks over
// the whole file ([0, size << 16)) and over each line of the file CHUNKS
// (BGZF virtual offsets, begin and end of each chunk in turn), and
// guac_decode_sam, and prints one line: the input, then each call's read
// count, or -1 and the library's reason (guac_last_error) where the call
// returned no handle, the fields separated by tabs.

#include <cstdint>
#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" {
void* guac_decode_bam(const char* path, int threads);
void* guac_decode_bam_chunks(const char* path, int threads, int64_t n_chunks,
                             const int64_t* vbeg, const int64_t* vend);
void* guac_decode_sam(const char* path, int threads);
int64_t guac_num_reads(void* h);
void guac_free_reads(void* h);
const char* guac_last_error();
}

static std::string count_and_free(void* handle) {
  if (handle == nullptr) return std::string("-1 ") + guac_last_error();
  long long n = guac_num_reads(handle);
  guac_free_reads(handle);
  return std::to_string(n);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s CHUNKS INPUT...\n", argv[0]);
    return 2;
  }
  std::vector<std::vector<int64_t>> lists;
  std::ifstream chunks(argv[1]);
  for (std::string line; std::getline(chunks, line);) {
    std::istringstream fields(line);
    std::vector<int64_t> offsets;
    for (int64_t v; fields >> v;) offsets.push_back(v);
    lists.push_back(offsets);
  }
  const int threads = 2;  // the inflate pools run with more than one thread
  for (int i = 2; i < argc; i++) {
    const char* path = argv[i];
    fprintf(stderr, "input %s\n", path);  // names the input of a report
    FILE* f = fopen(path, "rb");
    if (f == nullptr) return 2;
    fseek(f, 0, SEEK_END);
    int64_t size = ftell(f);
    fclose(f);

    std::vector<std::string> counts;
    counts.push_back(count_and_free(guac_decode_bam(path, threads)));
    int64_t whole_beg = 0, whole_end = size << 16;
    counts.push_back(count_and_free(
        guac_decode_bam_chunks(path, threads, 1, &whole_beg, &whole_end)));
    for (const auto& offsets : lists) {
      std::vector<int64_t> vbeg, vend;
      for (size_t k = 0; k + 1 < offsets.size(); k += 2) {
        vbeg.push_back(offsets[k]);
        vend.push_back(offsets[k + 1]);
      }
      counts.push_back(count_and_free(guac_decode_bam_chunks(
          path, threads, (int64_t)vbeg.size(), vbeg.data(), vend.data())));
    }
    counts.push_back(count_and_free(guac_decode_sam(path, threads)));
    printf("%s", path);
    for (const std::string& n : counts) printf("\t%s", n.c_str());
    printf("\n");
  }
  return 0;
}
