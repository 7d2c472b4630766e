from emr2a_tpu_torch.pipelines.step2_embeddings.build_embeddings import main

if __name__ == "__main__":
    main()
